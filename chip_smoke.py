#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``lstm_tensorspark_torch``).

Run from the root of a checkout on a machine with one NVIDIA card::

    python3 chip_smoke.py

``python3 <this file> --tiled-pair LABEL``, run from the root of any
checkout of the port (this one or another, e.g. a parent commit
unpacked with ``git archive``), prints one line: that checkout's tiled
pair at config 5's shard in CUDA-event ms, so two designs can be timed
in turns on one card (parent, change, change, parent).
``python3 <this file> --residentx-fwd LABEL`` does the same for the
residentx forward at config 2: two directions with cs, one without;
``--resident-pair LABEL`` for the resident pair at config 1 (the forward
with residuals, the backward from them).

Phases (each one fails the run):

1. versions, and the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (``nvcc``, one
   process per source, all at once);
3. hold the decode-window kernel against its plain PyTorch version on the
   card, at config 1's shape (L=1, H=128, V=50; B in {1, 8, 16}, 8 being
   the batch bucket the serve burst dispatches; K in
   {1, 4, 8}; greedy and temperature with shared noise; EOS, budget-end and
   dead rows) and at config 3's width (L=2, H=650, V=33,278; B=4; K=4),
   plus config 5's width (L=4, H=1024) with a small head for the shared
   memory opt-in: tokens identical, h/c within 1e-5; time config 1 and 3
   with CUDA events;
4. serve: boot the HTTP server on 127.0.0.1 at config 1 full width with
   seeded weights, send 6 concurrent greedy ``/v1/generate`` requests
   (prompt lengths 3-40, 32 new tokens, one with ``eos_id``) and check the
   tokens against the plain ``generate`` on the CPU, that the window
   kernel's launch count rose during the run and that no decode ran the
   plain version on the card; then a prompt id outside the vocabulary
   must get a 400, and the burst after it must be served identical;
5. hold the LSTM recurrence kernels (``csrc/lstm_fwd.cu``,
   ``csrc/lstm_bwd.cu``) against their plain PyTorch versions at config 1
   (B=64, T=64, H=128) and config 3's width (B=32, T=70, H=650), with and
   without a mask, at a serve prefill batch (B=3, T=5, H=128, masked) and
   at two shapes that reach the backward's other builds (B=64, T=33,
   H=256: U^T in shared memory; B=512, T=9, H=128: more than four slots a
   warp),
   from non-zero carries, the forward with and without residuals, the
   backward from the plain forward's residuals and from the kernel's own
   (printing the plan each launched); time
   config 1 in turns (plain, kernel, kernel, plain) with CUDA events and
   under ``torch.profiler``, beside cuDNN's ``torch.nn.LSTM`` on the same
   shapes (the yardstick; the port never calls it) and the bound, each
   time also per step; then the pair's bfloat16 forms (xproj, z, dz and U
   bfloat16) against their plain twins at config 1, H=256 (U and U^T in
   shared memory), config 3's width and an awkward shape, masked and not
   (float32 values to 1e-3, the gradients dh0, dc0 to 3e-3 of their max,
   each stored bfloat16 element within one ulp or 1e-3 of the stream's
   scale), their plans and registers, timed at config 1 beside the twin,
   cuDNN in bfloat16 and the bound;
6. train config 1 through the CLI entry (``cli.main(["train", ...])``):
   the first 10 losses on the card against the same run on the CPU (plain
   versions, same seed and batches), and 5 of a 2-layer stack, then 300 steps with an eval every 100
   whose kernel launch counts must equal steps × layers (+ the eval
   forwards), steps/s and tokens/s, and the device idle share over 20
   steps under ``torch.profiler``;
7. hold the residentx kernels (``csrc/lstmx_fwd.cu``, ``csrc/lstmx_bwd.cu``)
   against their plain versions in all four roles — one direction and the
   stacked two directions of a bi-LSTM layer, forward and backward — at
   config 2 (B=32 per direction, T=400, D=H=256), masked with the IMDB
   stand-in's lengths and unmasked, at the LM's ``--seq-len 256`` shape
   (B=64, T=256, D=H=128; one direction), at an awkward shape (B=8,
   T=257, D=72, H=200), at two shapes whose forward runs 8-row clusters
   (B=40, T=64, D=72, H=200 masked; B=96, T=64, D=H=128; two directions)
   and at four that reach the forward's other builds (H=300: U in shared
   memory; H=650: through L2; H=5 and H=16: one block a cluster);
   time each role at the shape its launches in phase
   8 come from in turns (plain, kernel, kernel, plain) with CUDA events and
   under ``torch.profiler`` (each kernel's chain and its side kernel —
   the forward's projection, the backward's z rebuild — apart), beside
   cuDNN's ``torch.nn.LSTM`` (bidirectional for the stacked roles) and
   the bound, each time also per step; the backward runs from the plain
   forward's ys and cs and from the kernel's own; and time the stacked
   pair under the card's plan against the other row cut of each kernel;
   then the pair's bfloat16 forms (xs, W, U and dz bfloat16; zx, c, the
   gates, ys and cs float32) against their plain twins at config 2 (one
   and two directions, masked and not), the LM's T=256, the awkward
   shapes and the forward's other builds, from both the twin's and the
   kernel's own ys and cs (phase 5's bf16 limits), their plans and
   registers, each role timed at its main-path shape beside the twin,
   cuDNN in bfloat16 (bidirectional for the stacked roles) and the bf16
   bound;
8. train config 2 through the CLI: the first 10 losses on the card at
   ``--dropout 0``, without and with ``--remat-chunk 50``, against the same
   run on the CPU (without remat: the plain scan's values do not depend
   on it; a host run started before phase 2, beside the card's phases),
   with the steps/s of each (with remat: the residentx forward,
   then the plain recompute backward); 300 steps at ``--dropout 0.2``
   with an eval every 100, whose launch counts must equal the
   prediction; the LM at
   ``--seq-len 256`` (the single-direction residentx pair) for 10 steps
   against the CPU; and the device idle share over 20 config-2 steps under
   ``torch.profiler``;
9. hold the tiled kernels (``csrc/lstm_tiled_fwd.cu``,
   ``csrc/lstm_tiled_bwd.cu``) against their plain versions at config 5's
   per-chip shard (B=16, T=128, H=1024), at B=64 and B=256 (the widest
   tiled route) with H=1024, at config 3's width (B=32, T=70, H=650) and
   at two awkward shapes (B=6, T=33, H=1030; B=3, T=5, H=40, where the
   forward's plan takes more units a block to fit shared memory), masked
   and unmasked, from non-zero carries, the forward with and without
   residuals (bit-identical); print the card's resident clusters and each
   plan (blocks, cluster size, units, registers and shared memory a
   block); time both at config 5's shard in turns (plain, kernel, kernel,
   plain) with CUDA events and under ``torch.profiler``, beside cuDNN's
   ``torch.nn.LSTM``, the bound and the parent design's time; and time the
   tiled pair against the resident pair at config 3's width, the route
   rule's boundary; then the pair's bfloat16 forms as in phase 5 at config
   3 (B=32, T=70, H=650), config 5's shard and B=6, T=33, H=1030, timed at
   config 5's shard;
10. train config 5's model (4 x 1024 word LM on the WikiText-103
   stand-in, B=16, T=128, Adam 1e-3, clip 1.0, stateful, f32) through the
   CLI: the first 5 losses at ``--dropout 0`` on the card, without and
   with ``--remat-chunk 32``, against one CPU run; 200 steps at
   ``--dropout 0.2`` with an eval every 100, whose tiled launch counts must
   equal the prediction while every other recurrence counter stays at 0;
   steps/s, tokens/s, eval perplexity, and the device idle share over 20
   steps under ``torch.profiler``;
11. hold the speculative window kernel (``csrc/spec_window.cu``) against
   its plain version at config 1 (target L=1, H=128, V=50; the
   ``draft_config`` draft, H=32; B in {1, 8, 16}, k_draft in {1, 2, 4}; a
   random, an all-reject and an all-accept draft; EOS, budget-end and dead
   rows; a tied-head pair at B=8) and at config 3's width (L=2, H=650,
   V=33,278, draft H=162, B=4, k_draft=4): tokens, next, alive and
   remaining identical, the four carry arrays within 1e-5; time config 1
   (B=16, k_draft=4) and config 3 in turns (plain, kernel, kernel, plain)
   with CUDA events and under ``torch.profiler``, beside the bound and the
   plain decode window of W = k_draft + 1 steps;
12. speculative serving: boot the HTTP server at config 1 with seeded
   weights, plain, then ``speculative=True`` (ladder 2, 4) with the random
   ``draft_config`` draft and with the all-accept draft (the target
   itself); send phase 4's 6 concurrent greedy requests to each and check
   the tokens against the plain ``generate`` on the CPU, that the spec
   kernel's launches equal the spec windows dispatched, that no window ran
   the plain version, that the prefills launched ``lstm_fwd`` and that no
   draft prefill failed; print the mean accepted length, tokens/s, TTFT,
   max inter-token gap and the device idle share under ``torch.profiler``;
13. serve phase 4's burst at config 3's width (L=2, H=650, V=33,278):
   tokens against the CPU ``generate``, tokens/s, TTFT, gaps between
   tokens and the idle share;
14. train with K steps a call through the CLI, each run (captured as CUDA
   graphs, the default) against the same run with ``graph=False``: config
   1 at K=1, K=8 host-fed, K=8 ``--prefetch 2`` and K=8 ``--device-data
   --fused-eval`` (40 steps: every logged loss within 1e-5, the fused eval
   within 1e-6 of the host eval; a second eager run gives the floor of the
   differences), config 5's shard at K=4 with dropout 0.2 and config 2 at
   K=4 ``--device-data`` with dropout 0.2, each with and without remat;
   the captured run's launches less its capture warm-up's equal the eager
   run's; every run has a time limit (a hanging replay fails the phase).
   Then the runs the CLI builds (``cli.training``), driven call by call:
   under ``torch.profiler`` one ``cudaGraphLaunch`` a call and no kernel
   launch from the host (config 1 at K=1, K=8 ``--device-data`` and K=8
   ``--prefetch 2``); steps/s, device ms a step and the idle share of
   configs 1, 5 and 2 (with and without remat), eager and captured in
   turns (in the whole smoke config 1's alone: ``--train-calls`` times
   them all). Phases 6, 8 and 10 run captured too: their launch counts are
   checked with the warm-up launches taken out, and their profiled steps
   are the runs the CLI builds.

15. train the LM family in bf16 through the CLI, each run with its
   script's flags (``configs/ptb_char.sh``: config 1, bf16 compute;
   ``configs/wikitext2.sh``: config 3, 2x650, B=32, T=70, sgd 2.0, clip
   0.25, dropout 0.5, bf16 compute and logits, on the WikiText-2
   stand-in; ``configs/wikitext103_dp.sh`` at its per-chip batch of 16,
   with and without ``--remat-chunk 32``), captured: the first 5 losses
   at ``--dropout 0`` against the CPU run of the same command (within
   2e-3 of the loss: the card's kernels round the streams to bf16, the
   CPU's plain loop does not), the bf16 forms' launches (and no other
   recurrence kernel, no plain twin), 60 steps at the script's dropout,
   and steps/s, device ms a step and the idle share beside the float32
   run of the same command, in turns (f32, bf16, bf16, f32; a remat
   run's turns under ``--bf16 train`` only);
16. train config 2 in bf16 through the CLI as ``configs/imdb_bilstm.sh``
   runs it (B=32, T=400, H=256, Adam 1e-3, clip 1.0, dropout 0.2,
   ``--remat-chunk 50``: the residentx forward's bf16 form a direction,
   then the plain recompute), the same without remat (the stacked pair's
   bf16 forms) and the LM at ``--seq-len 256`` in bf16 (the one-direction
   pair), captured: the first 5 losses at ``--dropout 0`` within 2e-3 of
   the CPU run's (config 2's a host run beside the card), exact bf16
   launch counts with the capture warm-ups taken out (every other
   counter and the plain twins at 0), a 30-step run at the script's
   dropout, and steps/s, device ms a step, the idle share and the device
   ms a step by part beside the float32 run of the same command, in
   turns (the remat run's under ``--bf16 train`` or ``--bf16 residentx``
   only);
17. train, checkpoint, resume and serve that checkpoint in bf16: (a) the
   decode and spec windows' bf16 forms (W and U bfloat16) against their
   plain twins at config 1 (decode B=16, K=8, greedy, sampled and with
   bf16 logits; spec k_draft=4, a random and the all-accept draft) and
   config 3's width (B=4, K=4; k_draft=4): tokens identical, carries
   within phase 5's bf16 limit (1e-3), each timed beside its float32 form
   in turns (f32, bf16, bf16, f32), its plain twin, its device ms and its
   bound; the recurrence forwards' plain-rounding forms (xproj float32, U
   bfloat16: the serve prefill's) against their twins at a prefill batch
   of config 1 (resident) and config 3's width (tiled); (b) config 1
   trained as ``configs/ptb_char.sh`` runs it (bf16), captured, with
   ``--checkpoint-dir --checkpoint-every``, then resumed from the oldest
   checkpoint kept: every later loss equal to the whole run's bit for bit,
   at K=1 host-fed and K=8 ``--device-data``; (c) ``serve --http
   --compute-dtype bfloat16 --checkpoint-dir`` on that checkpoint as a
   subprocess, plain and ``--speculative``: phase 4's burst, tokens equal
   to the CPU plain ``generate`` of the checkpoint in bf16, the bf16
   windows' and the prefill form's launches from the server's
   ``/v1/stats`` (no other kernel, no plain twin), tokens/s, TTFT and the
   largest gap between tokens; (d) phase 13's burst at config 3's width in
   bf16;
18. train config 4, the seq2seq forecaster, as ``configs/uci_forecast.sh``
   runs it (the uci_electricity stand-in, F=8 series, context 168 h,
   horizon 24 h, H=128, B=64, Adam 1e-3, clip 1.0, bf16): (a) the resident
   pair at its shapes chained under autograd as the forecaster chains it
   (the encoder at T=168 from non-zero carries, its final carries the
   decoder's at T=24, the encoder's ys unused), f32 and bf16, against the
   same chain through the plain twins (ys, hT, cT; the gradients of both
   xprojs, both Us, h0, c0 and the encoder's inputs; phase 5's limits),
   each kernel timed at its shape beside its twin and its bound; (b) the
   command through the CLI, captured, in bf16 and in float32: the first 5
   losses against the CPU run of the same command (a host run beside the
   card; 2e-3 of the loss in bf16, phase 6's limit in float32), the
   launches of a 40-step run with an eval every 20 (the pair's forms twice
   a step and once an eval batch, no other kernel, no plain twin, the
   capture warm-ups taken out), K=8 ``--device-data --fused-eval`` against
   host-fed K=1, and resume bit for bit at K=1 and K=8 ``--device-data``;
   (c) steps/s, device ms a step and the idle share, eager against
   captured in turns;
19. serve as ``cli serve`` runs by default (the prefix cache and the
   session tiers on): the resident forward (f32 and its plain-rounding
   bf16 form) at a config-1 prefill batch (B=8, T=16) and the tiled
   forward's plain-rounding form at config 3's width (B=4, T=64) from
   non-zero carries over masked rows against their plain twins (1e-5 in
   f32, 1e-3 in bf16); (a) 24 conversations x 3 turns at config 1, f32
   and bf16, over 8 slots, a host tier of 8 and a disk tier (every
   conversation ends a turn before any starts the next): each turn's
   tokens equal the CPU plain ``generate`` of the whole context so far,
   with the fills by tier (device slot, pending spill, host, disk) and the
   spills printed, and no miss; (b) 16 prompts sharing a 96-token prefix
   after one request that inserts it, with the prefix cache off, on, and
   on with speculative windows: identical tokens, hits, tokens saved, TTFT
   p50 / p99; (c) prompts of 300, 517, 800 and 1000 tokens at
   ``prefill_chunk`` 64 beside 8 decoding sessions: tokens against the
   CPU, chunk dispatches, the short sessions' largest gap while the long
   ones prefill; (d) ``serve --http --session-dir D`` as a subprocess: 4
   kept sessions, their files awaited, SIGKILL, a boot on D, the sessions
   continued identical to the uninterrupted run from 4 disk fills; (e)
   config 3's width in bf16, 4 conversations x 2 turns, one of 200 tokens
   chunked at 64. Its launches join the kernel report's rows;
20. serve under load as ``cli serve`` runs by default (the router's
   admission classes and deadlines, the registry): (a) at config 1, f32
   and bf16, a 1 ms request, then a burst of 32 over HTTP at
   ``--queue-size 8``, half best_effort, every eighth with a deadline it
   cannot meet: only best_effort shed below the full bound, every shed
   with ``Retry-After`` >= 1 s and a hint >= 0.05 s, completed tokens
   equal to the CPU plain ``generate``, partial tokens of a timeout a
   prefix of it, and afterwards no pinned slot, no session and no tier
   copy of a timed-out request; (b) ``serve --loadgen`` as a subprocess,
   closed-loop and ``--idle-churn``: a strict-JSON report whose counts add
   up per class, its tokens/s, TTFT and gaps printed; (c) ``serve --http``
   with default flags: ``GET /metrics`` parses, and its completed count and
   TTFT histogram count equal the requests served. Its launches (a, c)
   join the kernel report's rows.

Each phase prints the seconds it took. ``python3 <this file>
--loadgen`` runs phase 20 alone (about 2 minutes of the tool's time);
``--sessions`` runs phase 19 alone; ``--forecast`` runs phase 18 alone; ``--train-calls LABEL`` phase 14 alone; ``--bf16 train`` the bf16
parts of phases 5, 7 and 9 and phases 15 and 16 (``--bf16 kernels``
without phases 15 and 16, ``--bf16 residentx`` phase 7's bf16 part and
phase 16 alone, ``--bf16 windows`` phase 17a alone, ``--bf16 serve``
phase 17).

The last lines are the kernel report (one JSON object), the card's
``name, power.limit`` line, and ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a card or without the package.
"""

from __future__ import annotations

import atexit
import functools
import gc
import http.client
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

TOL = 1e-5
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
CONFIG1 = dict(vocab=50, hidden=128, layers=1)
CONFIG3 = dict(vocab=33278, hidden=650, layers=2)
# config 5's width (4 x 1024) with a small head: a grid launch whose layers
# stream through L2 while the head's slices stay on chip
CONFIG5_GATES = dict(vocab=1000, hidden=1024, layers=4)
# a wide model with config 1's vocabulary at B=1: more blocks (one an SM)
# than head columns, so most blocks own none
WIDE_NARROW_HEAD = dict(vocab=50, hidden=1024, layers=2)
# a mid-size model: a grid launch whose layer slices stay in shared memory
# (the head's slices stream); its draft (H=128) likewise
MID_LAYERS_ON_CHIP = dict(vocab=10000, hidden=512, layers=2)
# a tiny model at a batch of thousands of rows: the rows' latches go to
# global scratch, a copy a block (decode B=14,000; spec B=6,000, k_draft=2)
MANY_ROWS = dict(vocab=50, hidden=8, layers=1)
# what the plan of those two must be, else the case drives another path
PLAN_WANTED = {
    "mid-layers-on-chip": ("a grid with the layer slices in shared memory",
                           lambda p: not p.cluster and p.layers_smem),
    "many-rows": ("the rows' latches in global scratch",
                  lambda p: not p.cluster and not p.rows_smem)}
# the recurrence kernels' shapes: config 1's training window, and config 3's
# width (a hidden size that is no multiple of a block's share)
LSTM_CONFIG1 = dict(B=64, T=64, H=128)
LSTM_CONFIG3 = dict(B=32, T=70, H=650)
# a serve prefill batch at config 1's width: 3 prompts in a length bucket
# of 5, right-padded (the resident forward alone, no residuals)
LSTM_PREFILL = dict(B=3, T=5, H=128)
# the backward's other builds (csrc/lstm_bwd.cu): U^T's slice in shared
# memory (H=256), and a warp taking more than four (unit quad, row quad)
# slots (B=512 over the card's resident clusters of 4)
LSTM_UT_SMEM = dict(B=64, T=33, H=256)
LSTM_SLOTS = dict(B=512, T=9, H=128)
# values (h, c, bounded by the gates) are held to 1e-5 absolute; the
# pre-activations z and the gradients (dz, dh0, dc0) are sums of H or 4H
# products, so their float32 rounding scales with their size: held to
# 1e-5 of max(1, max |reference|)
LSTM_TOL = 1e-5
# ten SGD steps at lr 0.5 compound the float32 rounding of differently
# ordered sums (kernel vs the CPU's plain loop) into the losses
TRAIN_LOSS_TOL = 1e-4
TRAIN_FLAGS = ["train", "--dataset", "ptb_char", "--hidden-units", "128",
               "--num-layers", "1", "--batch-size", "64", "--seq-len", "64",
               "--learning-rate", "0.5", "--stateful", "--compute-dtype",
               "float32"]
TRAIN_STEPS, EVAL_EVERY, EVAL_BATCHES = 300, 100, 8
# config 2: the bi-LSTM classifier on the IMDB stand-in (B=32, T=400,
# E=H=256, V=113), Adam 1e-3, clip 1.0
CONFIG2 = dict(B=32, T=400, D=256, H=256)
CONFIG2_FLAGS = ["train", "--dataset", "imdb", "--hidden-units", "256",
                 "--num-layers", "1", "--batch-size", "32", "--seq-len",
                 "400", "--optimizer", "adam", "--learning-rate", "1e-3",
                 "--clip-norm", "1.0", "--compute-dtype", "float32"]
CONFIG2_STEPS, CONFIG2_EVAL_EVERY = 300, 100
# the first losses held against the CPU run of the same command
CONFIG2_FIRST = 10


def first_flags(flags, n):
    """``flags`` for a run of the first ``n`` losses: one a step, dropout
    off, one eval batch."""
    return flags + ["--num-steps", str(n), "--log-every", "1", "--dropout",
                    "0", "--eval-batches", "1"]


def host_references():
    """(name, flags) of the host runs the card's first losses are held
    against (HostRuns): config 2 in float32 (phase 8) and in bf16 (phase
    16). Config 4's (phase 18, :func:`config4_references`) start when
    phase 16 has read config 2's."""
    return (("config2 f32", first_flags(CONFIG2_FLAGS, CONFIG2_FIRST)),
            ("config2 bf16", first_flags(CONFIG2_BF16_FLAGS, BF16_FIRST)))
AWKWARD = dict(B=8, T=257, D=72, H=200)
# the residentx forward's 8-row clusters (two columns a thread) at an
# awkward width (58 column pairs of 64) and at the LM's width (64 terms a
# piece)
AWKWARD8 = dict(B=40, T=64, D=72, H=200)
LM8 = dict(B=96, T=64, D=128, H=128)
# the forward's other builds: U's slice in shared memory (a piece of 300
# terms), read through L2 (H=650, more (unit, row) items than threads),
# and narrow widths (one block a cluster)
LSTMX_SMEM = dict(B=32, T=64, D=256, H=300)
LSTMX_L2 = dict(B=8, T=40, D=64, H=650)
LSTMX_TINY = dict(B=3, T=5, D=7, H=5)
LSTMX_SMALL = dict(B=8, T=9, D=12, H=16)
# config 1's LM at --seq-len 256 (E=H=128): the single-direction
# residentx pair
LM256 = dict(B=64, T=256, D=128, H=128)
# config 5's model (4 x 1024 word LM, T=128) at its per-chip batch (a global
# batch of 256 over 16 chips): every layer runs the tiled pair
CONFIG5 = dict(B=16, T=128, H=1024, L=4)
LSTM_CONFIG5 = dict(B=16, T=128, H=1024)
LSTM_B64 = dict(B=64, T=128, H=1024)
# the widest batch the tiled route takes at config 5's width, and an awkward
# tiled shape: B no multiple of 4, H no multiple of a block's units, a lane's
# rows of U past its registers, warps left out of the product
LSTM_B256 = dict(B=256, T=128, H=1024)
LSTM_TILED_AWKWARD = dict(B=6, T=33, H=1030)
# a narrow tiled shape: the forward's plan takes more units a block than
# cover H (its many slots' zero tail of h would not fit shared memory)
LSTM_TILED_NARROW = dict(B=3, T=5, H=40)
# the parent design of the tiled pair (one block an SM, a grid-wide barrier
# a step), CUDA-event ms at config 5's shard on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md section 6): what the redesign is held against
TILED_PARENT_MS = {"fwd": 1.5161, "bwd": 3.3631}
CONFIG5_FLAGS = ["train", "--dataset", "wikitext103", "--hidden-units",
                 "1024", "--num-layers", "4", "--batch-size", "16",
                 "--seq-len", "128", "--optimizer", "adam", "--learning-rate",
                 "1e-3", "--clip-norm", "1.0", "--stateful",
                 "--compute-dtype", "float32", "--logits-dtype", "float32"]
CONFIG5_FIRST = 5
CONFIG5_STEPS, CONFIG5_EVAL_EVERY, CONFIG5_EVAL_BATCHES = 200, 100, 8
# phase 14: each CLI run captured (the default) against the same run with
# graph=False; the losses differ only by the atomic float adds of the
# embedding gradient (index_select's backward), which differ from one
# eager run to the next as well
CALLS_TOL = 1e-5
# a fused eval against the host eval of the same params: float32 sums in
# another order than the host's double accumulation
FUSED_EVAL_TOL = 1e-6
CALLS_STEPS = 40
# a CLI run of phase 14 that has not ended by then hangs in a replay: the
# phase fails (the kernels' own spins trap after about two seconds)
CALL_RUN_LIMIT_S = 240


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class HostRuns:
    """The CLI runs on the host's CPU that the card's first losses are held
    against (config 2's in phases 8 and 16, each over a minute), started as
    subprocesses (``python -m lstm_tensorspark_torch train ... --device
    cpu``, niced, ``HOST_THREADS`` threads each) before the kernels are
    built, so they run beside the card's phases; a phase waits for its own
    run's losses. ``stop`` kills every run still going (the script
    registers it to run at exit)."""

    def __init__(self):
        self.runs, self.done = {}, {}
        self.dir = None

    def start(self, name, flags):
        """Start the run ``train <flags> --device cpu`` as ``name`` (once)."""
        if name in self.runs:
            return
        self.dir = self.dir or tempfile.mkdtemp(prefix="chip_smoke_host_")
        path = os.path.join(self.dir, f"{name}.jsonl")
        err = open(os.path.join(self.dir, f"{name}.err"), "w+")
        env = {**os.environ, "OMP_NUM_THREADS": str(HOST_THREADS)}
        proc = subprocess.Popen(
            [sys.executable, "-m", "lstm_tensorspark_torch", *flags,
             "--device", "cpu", "--jsonl", path],
            stdout=subprocess.DEVNULL, stderr=err, env=env,
            preexec_fn=lambda: os.nice(10))
        self.runs[name] = (proc, path, err, time.perf_counter())

    def losses(self, name, flags):
        """The logged losses of run ``name`` (started now unless it was),
        once it has ended; fails the script when it did not end well."""
        if name in self.done:
            return self.done[name]
        self.start(name, flags)
        proc, path, err, t0 = self.runs[name]
        t_wait = time.perf_counter()
        try:
            rc = proc.wait(timeout=HOST_RUN_LIMIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"host run {name} did not end in {HOST_RUN_LIMIT_S} s")
        if rc != 0:
            err.seek(0)
            fail(f"host run {name} exited {rc}: {err.read()[-2000:]}")
        with open(path) as f:
            losses = [json.loads(line)["loss"] for line in f
                      if '"loss"' in line]
        print(f"  host run {name}: {time.perf_counter() - t0:.1f} s beside "
              f"the card, {time.perf_counter() - t_wait:.1f} s waited for",
              flush=True)
        self.done[name] = losses
        return losses

    def stop(self):
        for proc, _, err, _ in self.runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()


HOST_THREADS = 3
HOST_RUN_LIMIT_S = 900


def make_model(torch, tlm, gen_seed, vocab, hidden, layers, device):
    cfg = tlm.LMConfig(vocab_size=vocab, hidden_size=hidden, num_layers=layers)
    params = tlm.init_lm(torch.Generator().manual_seed(gen_seed), cfg)
    return cfg, params, tlm.params_to(params, device)


def window_inputs(torch, cd, weights, cfg, B, K, greedy, seed, device,
                  edge_rows):
    """Carries, latches and noise for one window; with ``edge_rows`` row 0
    gets an EOS id it really emits, row 1 a budget ending mid-window, row 2
    is dead on entry."""
    g = torch.Generator().manual_seed(seed)
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    h = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    c = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    tok = torch.randint(0, V, (B,), generator=g, dtype=torch.int32).to(device)
    noise = None
    if not greedy:
        u = torch.rand((K, B, V), generator=g).clamp_min(1e-38)
        noise = (-torch.log(-torch.log(u))).to(device)
    alive = torch.ones(B, dtype=torch.int32, device=device)
    rem = torch.full((B,), K + 3, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    if edge_rows:
        probe = cd.decode_window_reference(
            weights, h, c, tok, alive, rem, eos, noise, window=K,
            temperature=0.7, greedy=greedy)[2]
        eos[0] = probe[K // 2, 0]
        if B > 2:
            rem[1] = max(1, K // 2)
            alive[2] = 0
            rem[2] = 0
    return h, c, tok, alive, rem, eos, noise


def compare(torch, cd, weights, inputs, K, greedy, label):
    """Kernel vs plain version on the same inputs; returns the max abs h/c
    difference and the number of live row-steps (non-PAD tokens)."""
    args = dict(window=K, temperature=0.7, greedy=greedy)
    got = cd.decode_window(weights, *inputs, **args)
    ref = cd.decode_window_reference(weights, *inputs, **args)
    torch.cuda.synchronize()
    names = ("h", "c", "tokens", "next", "alive", "remaining")
    for name, a, b in zip(names[2:], got[2:], ref[2:]):
        if not torch.equal(a, b):
            fail(f"{label}: kernel {name} differ from the plain version:\n"
                 f"kernel {a.tolist()}\nplain  {b.tolist()}")
    err = max(float((got[0] - ref[0]).abs().max()),
              float((got[1] - ref[1]).abs().max()))
    if err > TOL:
        fail(f"{label}: h/c differ by {err:.3e} > {TOL}")
    return err, int((got[2] != cd.PAD_TOKEN).sum())


def time_ms(torch, fn, iters):
    for _ in range(3):
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


def device_profile(torch, fn, calls=None, cpu=True):
    """Device-side view of ``fn()`` from ``torch.profiler``: (device busy
    ms summed over all kernels and copies, wall ms, {name: device ms},
    {name: events recorded}) — or None when the profiler records no device
    time. The profiler can miss the first launches of a window, so a
    per-launch time divides by the events recorded, not by the calls.
    ``cpu=False`` records the device alone (a step of many small host ops
    otherwise takes the profiler long to sum)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, counts = {}, {}
    for evt in prof.key_averages():
        # device-side events only (kernels, copies): the CPU operators that
        # launched them also report their children's device time, and
        # summing both would count every kernel twice
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[evt.key] = us / 1e3
            counts[evt.key] = evt.count
    if not by_name:
        return None
    return sum(by_name.values()), wall * 1e3, by_name, counts


def bound(cfg, B, K, row_steps, sampled):
    """Least time for one window: the larger of bytes over HBM bandwidth
    (each input read once, each output written once; embedding rows as
    gathered) and float32 FLOPs over the card's peak."""
    L, H, V, E = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.embed
    weights = sum(((E if l == 0 else H) + H) * 4 * H + 4 * H for l in range(L))
    weights += H * V + V
    emb_rows = min(row_steps, V) * E
    floats = weights + emb_rows + 4 * L * B * H + (K * B * V if sampled else 0)
    ints = 4 * B + K * B + 3 * B
    nbytes = 4 * (floats + ints)
    per_step = 2 * (sum(((E if l == 0 else H) + H) * 4 * H
                        for l in range(L)) + H * V)
    flops = row_steps * per_step
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def step_floor_ms(nbytes):
    """The per-step floor: weight bytes that the plan cannot keep on chip,
    read once per step, over HBM bandwidth."""
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def tie_weights(torch, cd, weights, pairs, boost):
    """``weights`` with head column j made a copy of column i (weights and
    bias, plus ``boost`` on both biases) for each (i, j) in ``pairs``: the
    two logits are then equal however the sums are ordered, so the argmax
    must keep the lower index, whichever block or lane holds each."""
    hw = weights.head_kernel.clone()
    hb = weights.head_bias.clone()
    for i, j in pairs:
        hb[i] += boost
        hw[:, j] = hw[:, i]
        hb[j] = hb[i]
    return cd.DecodeWeights(weights.embedding, weights.layers, hw, hb)


def tie_cases(cd, cfg, B, K, device):
    """Head-column ties for the plan this shape takes: across two blocks'
    slices (the last column of block 0's slice and the first of block
    1's) in a grid launch, and inside one block (two lanes' columns, and
    two columns of one lane's stride) in a one-cluster launch."""
    V = cfg.vocab_size
    p = cd.card_plan(((cfg.num_layers, cfg.hidden_size, cfg.embed),), V, B,
                     K, device)
    if p.cluster:
        return [(31, 32), (5, 37)]
    # the first column whose block differs from its left neighbour's
    # (csrc split_at: block j owns [V j / blocks, V (j + 1) / blocks))
    b = max(1, V // p.blocks)
    return [(b - 1, b)]


def check_plan(name, plan):
    """Fail unless case ``name`` takes the plan it is there to drive."""
    if name in PLAN_WANTED and not PLAN_WANTED[name][1](plan):
        fail(f"{name}: the plan is not {PLAN_WANTED[name][0]}: {plan}")


def kernel_phase(torch, tlm, tgen, cd, device):
    print("== phase 3: decode-window kernel vs plain version", flush=True)
    max_err = 0.0
    timings = {}
    for name, spec, cases, timed in (
            ("config1", CONFIG1,
             [(B, K, g) for B in (1, 8, 16) for K in (1, 4, 8)
              for g in (True, False)], (16, 8)),
            ("config3", CONFIG3, [(4, 4, True), (4, 4, False)], (4, 4)),
            ("config5-gates", CONFIG5_GATES, [(2, 2, True)], None),
            ("wide-narrow-head", WIDE_NARROW_HEAD, [(1, 3, True)], None),
            ("mid-layers-on-chip", MID_LAYERS_ON_CHIP,
             [(4, 4, True), (4, 4, False)], None),
            ("many-rows", MANY_ROWS, [(14000, 2, True)], None)):
        cfg, _, params = make_model(torch, tlm, 1, device=device, **spec)
        weights = cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                                    cfg.tie_embeddings)
        shape = ((cfg.num_layers, cfg.hidden_size, cfg.embed),)
        for i, (B, K, greedy) in enumerate(cases):
            check_plan(name, cd.card_plan(shape, cfg.vocab_size, B, None,
                                          device))
            inputs = window_inputs(torch, cd, weights, cfg, B, K, greedy,
                                   seed=100 + i, device=device,
                                   edge_rows=B > 1)
            err, _ = compare(torch, cd, weights, inputs, K, greedy,
                             f"{name} B={B} K={K} greedy={greedy}")
            max_err = max(max_err, err)
            print(f"  {name} L={cfg.num_layers} H={cfg.hidden_size} "
                  f"V={cfg.vocab_size} B={B} K={K} greedy={greedy}: tokens "
                  f"identical, max |dh|,|dc| = {err:.3e}; "
                  f"{cd.card_plan(shape, cfg.vocab_size, B, None, device)}",
                  flush=True)
        # exact ties in the head, where the blocks or lanes split it
        B, K = cases[-1][0], cases[-1][1]
        for pair in tie_cases(cd, cfg, B, None, device):
            tied = tie_weights(torch, cd, weights, [pair], 50.0)
            inputs = window_inputs(torch, cd, tied, cfg, B, K, True, seed=99,
                                   device=device, edge_rows=False)
            err, _ = compare(torch, cd, tied, inputs, K, True,
                             f"{name} tied columns {pair}")
            toks = cd.decode_window(tied, *inputs, window=K, temperature=1.0,
                                    greedy=True)[2]
            if not bool((toks == pair[0]).any()):
                fail(f"{name}: the tied columns {pair} never won the argmax")
            max_err = max(max_err, err)
            print(f"  {name} B={B} K={K} with head columns {pair} tied: "
                  f"tokens identical (the lower index wins), max |dh|,|dc| "
                  f"= {err:.3e}", flush=True)
        if timed is None:
            continue
        B, K = timed
        inputs = window_inputs(torch, cd, weights, cfg, B, K, True,
                               seed=7, device=device, edge_rows=False)
        _, row_steps = compare(torch, cd, weights, inputs, K, True, name)
        args = dict(window=K, temperature=1.0, greedy=True)
        iters = 200 if name == "config1" else 20

        def kernel():
            return cd.decode_window(weights, *inputs, **args)

        def plain():
            return cd.decode_window_reference(weights, *inputs, **args)

        # in turns (plain, kernel, kernel, plain) so drift hits both alike
        p1 = time_ms(torch, plain, iters)
        k1 = time_ms(torch, kernel, iters)
        k2 = time_ms(torch, kernel, iters)
        p2 = time_ms(torch, plain, iters)
        bound_ms, bound_by = bound(cfg, B, K, row_steps, sampled=False)
        plan = cd.card_plan(shape, cfg.vocab_size, B, None, device)
        floor = step_floor_ms(sum(plan.offchip_bytes[0]))
        timings[name] = dict(B=B, K=K, kernel_ms=(k1 + k2) / 2,
                             plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                             bound_by=bound_by, row_steps=row_steps,
                             floor_ms=floor * K)
        print(f"  {name} B={B} K={K} greedy: kernel_ms "
              f"{timings[name]['kernel_ms']:.4f} ({k1:.4f}, {k2:.4f}), "
              f"plain_ms {timings[name]['plain_ms']:.4f} ({p1:.4f}, "
              f"{p2:.4f}), bound_ms {bound_ms:.6f} ({bound_by}); per-step "
              f"floor {floor:.6f} ms ({sum(plan.offchip_bytes[0])} weight "
              f"bytes off chip a step), {floor * K:.6f} ms a window; "
              f"launches so far {cd.counts.kernel}", flush=True)
        for label, fn in (("kernel", kernel), ("plain", plain)):
            prof = device_profile(torch, lambda: [fn() for _ in range(20)])
            if prof is None:
                print(f"  {name} {label}: the profiler recorded no device "
                      "time (device busy not measured)", flush=True)
                continue
            busy, wall, by_name, _ = prof
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
            print(f"  {name} {label} x20 under torch.profiler: device busy "
                  f"{busy / 20:.4f} ms of {wall / 20:.4f} ms wall per call; "
                  "top: " + "; ".join(f"{k[:48]} {v / 20:.4f} ms"
                                      for k, v in top), flush=True)
    return max_err, timings


def post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def serve_phase(torch, tlm, tgen, cd, serve, device):
    print("== phase 4: serve config 1 over HTTP", flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=32,
                               rng_seed=0)
    server = serve.ServeServer(engine, max_active=16)
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, cfg.vocab_size, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params_cpu, [p], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    # request 5's eos_id is a token its greedy run first emits at step 8 or
    # later, so the served request stops inside a decode window (on the
    # kernel's EOS latch), not at the token prefill samples
    eos_at = next((i for i in range(8, n_new) if refs[5][i] not in refs[5][:i]),
                  None)
    if eos_at is None:
        fail(f"no token of {refs[5]} first appears at step 8 or later")
    eos = refs[5][eos_at]
    expect = [list(r) for r in refs]
    expect[5] = refs[5][:eos_at + 1]
    t0 = time.perf_counter()
    n = server.warmup(prompt_lens=lens)
    torch.cuda.synchronize()
    print(f"  warm-up: {n} dispatches in {time.perf_counter() - t0:.2f} s",
          flush=True)
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    def burst():
        """The 6 requests at once; returns (results, wall seconds)."""
        results = [None] * len(prompts)

        def run(i):
            body = {"prompt": prompts[i], "max_new_tokens": n_new,
                    "greedy": True}
            if i == 5:
                body["eos_id"] = eos
            results[i] = post(port, body)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads):
            fail("a request did not finish")
        for i, r in enumerate(results):
            if r is None or r[0] != 200:
                fail(f"request {i} failed: {r}")
            if r[1]["tokens"] != expect[i]:
                fail(f"request {i}: served tokens {r[1]['tokens']} != plain "
                     f"generate on the CPU {expect[i]}")
        return results, time.perf_counter() - t0

    try:
        with server:
            cd.counts.reset()
            results, wall = burst()
            launches, plain_windows = cd.counts.kernel, cd.counts.reference
            stats = server.stats()
            # the same burst again under the profiler: where the serve
            # path's device time goes, and how idle the card is
            prof = device_profile(torch, burst)
            # a prompt id outside the vocabulary is refused (400) before it
            # reaches the card, where its gather would be a device-side
            # assert; the server then serves the burst again
            bad = post(port, {"prompt": [1, cfg.vocab_size, 2],
                              "max_new_tokens": 4, "greedy": True})
            if bad[0] != 400:
                fail(f"an out-of-range prompt id got {bad}, not a 400")
            burst()
            torch.cuda.synchronize()
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(30)
    if launches < 1:
        fail("the serve run launched the decode-window kernel no time")
    if plain_windows != 0 or stats["engine"]["decode_kernel"] != "cuda":
        fail(f"the engine ran {plain_windows} plain decode windows on the card")
    if not sum(stats["batcher"]["windows_dispatched"].values()):
        fail("the serve run dispatched no multi-token decode window")
    # the tokens matched expect[5], so request 5 stopped at its eos_id after
    # eos_at tokens that decode windows produced on the card
    print(f"  an out-of-range prompt id got 400 ({bad[1]['error']}); the "
          f"burst after it was served identical again", flush=True)
    print(f"  request 5 stopped on eos_id {eos} at step {eos_at} of {n_new}: "
          f"{eos_at} of its tokens came from decode windows", flush=True)
    tokens = sum(len(r[1]["tokens"]) for r in results)
    print(f"  6 concurrent requests: tokens identical to the plain generate "
          f"on the CPU; {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s; kernel launches {launches} "
          f"({launches / tokens:.3f} per token); windows "
          f"{stats['batcher']['windows_dispatched']}", flush=True)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in results)
    print(f"  ttft_ms per request {ttft} (median {ttft[len(ttft) // 2]}); "
          f"max_itl_ms per request {itl}", flush=True)
    if prof is None:
        print("  serve under torch.profiler: no device time recorded "
              "(device idle share not measured)", flush=True)
    else:
        busy, pwall, by_name, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"  serve burst under torch.profiler: device busy {busy:.3f} ms "
              f"of {pwall:.3f} ms wall (idle share "
              f"{1 - busy / pwall:.3f}); top: "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    return launches, tokens


def lstm_inputs(torch, B, T, H, masked, seed, device):
    """Seeded inputs of one layer's recurrence: xproj, U, h0, c0, mask (or
    None) and the backward's cotangents dys, dhT, dcT, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    G = 4 * H
    xproj = torch.randn(T, B, G, generator=g)
    U = torch.randn(H, G, generator=g) / H ** 0.5
    h0 = torch.randn(B, H, generator=g) * 0.5
    c0 = torch.randn(B, H, generator=g) * 0.5
    mask = None
    if masked:  # right padding of assorted lengths
        lens = torch.randint(1, T + 1, (B,), generator=g)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float()
    dys = torch.randn(T, B, H, generator=g)
    dhT = torch.randn(B, H, generator=g)
    dcT = torch.randn(B, H, generator=g)

    def dev(t):
        return None if t is None else t.to(device).contiguous()

    return [dev(t) for t in (xproj, U, h0, c0, mask)], \
        [dev(t) for t in (dys, dhT, dcT)]


def held(torch, name, got, ref, label, scaled):
    """max |got - ref|, failing the run above LSTM_TOL (scaled by the
    reference's size for sums of products)."""
    err = float((got - ref).abs().max())
    tol = LSTM_TOL * (max(1.0, float(ref.abs().max())) if scaled else 1.0)
    if not err <= tol:
        fail(f"{label}: kernel {name} differs from the plain version by "
             f"{err:.3e} > {tol:.3e}")
    return err


def lstm_bound(B, T, H, kind, masked=False):
    """Least time of one call: the larger of the bytes it must move (each
    input read once, each output written once) over HBM bandwidth and its
    products' FLOPs (2·T·B·H·4H) over the float32 peak."""
    G = 4 * H
    if kind == "fwd":  # xproj, U, h0, c0 in; ys, hT, cT, z, cs out
        floats = T * B * G + H * G + 2 * B * H + T * B * H + 2 * B * H \
            + T * B * G + T * B * H
    else:  # z, dys, cs, c0, U, dhT, dcT in; dz, dh0, dc0 out
        floats = T * B * G + 2 * T * B * H + B * H + G * H + 2 * B * H \
            + T * B * G + 2 * B * H
    nbytes = 4 * (floats + (T * B if masked else 0))
    flops = 2 * T * B * H * G
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_yardstick(torch, forward, layer_scan, inputs, cots):
    """cuDNN's ``torch.nn.LSTM`` on one layer at the same B, T, H: input
    weights W [H, 4H] and bias b drawn here, U copied across (the gate order
    i, f, g, o is the same in both; ``bias_hh`` is 0), TF32 off. It computes
    the same function as the kernel ``forward`` fed ``xproj = x @ W + b``,
    plus that input product; its backward also gives dW, dU, db and dx.
    Returns (forward ms, backward-alone ms, forward + backward ms, max |ys
    - ys of the forward kernel|, and the port's whole layer forward +
    backward ms: ``layer_scan`` through both kernels and the matmuls
    around them, the same function as cuDNN's forward + backward)."""
    xproj, U, h0, c0, _ = inputs
    dys, dhT, dcT = cots
    T, B, G = xproj.shape
    H = G // 4
    dev = xproj.device
    g = torch.Generator().manual_seed(5)
    W = (torch.randn(H, G, generator=g) / H ** 0.5).to(dev)
    b = (torch.randn(G, generator=g) * 0.1).to(dev)
    x = torch.randn(T, B, H, generator=g).to(dev)
    lstm = torch.nn.LSTM(H, H).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(W.T)
        lstm.weight_hh_l0.copy_(U.T)
        lstm.bias_ih_l0.copy_(b)
        lstm.bias_hh_l0.zero_()
    xg = x.clone().requires_grad_()
    hc = (h0[None].clone().requires_grad_(), c0[None].clone().requires_grad_())
    params = [xg, *hc, *lstm.parameters()]
    grads_out = [dys, dhT[None], dcT[None]]

    def fwd():
        return lstm(xg, hc)

    ys, (hT, cT) = fwd()
    kys = forward((x @ W + b).contiguous(), U, h0, c0)[0]
    torch.cuda.synchronize()
    diff = float((ys.detach() - kys).abs().max())

    def bwd():
        return torch.autograd.grad([ys, hT, cT], params, grads_out,
                                   retain_graph=True)

    def both():
        y, (h, c) = fwd()
        return torch.autograd.grad([y, h, c], params, grads_out)

    from lstm_tensorspark_torch.ops.lstm_cell import LSTMParams

    gates = [t.contiguous().requires_grad_()
             for t in (*W.split(H, 1), *U.split(H, 1), *b.split(H))]
    lp = LSTMParams(*gates)
    xs = x.transpose(0, 1).contiguous().requires_grad_()
    h0g, c0g = h0.clone().requires_grad_(), c0.clone().requires_grad_()
    port_out = [dys.transpose(0, 1), dhT, dcT]

    def port_both():
        (h, c), y = layer_scan(lp, xs, (h0g, c0g))
        return torch.autograd.grad([y, h, c], [*gates, xs, h0g, c0g],
                                   port_out)

    return (time_ms(torch, fwd, 50), time_ms(torch, bwd, 50),
            time_ms(torch, both, 50), diff, time_ms(torch, port_both, 50))


def lstm_kernel_phase(torch, cl, device):
    print("== phase 5: LSTM recurrence kernels vs plain versions", flush=True)
    errs = {"fwd": 0.0, "bwd": 0.0}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name, spec in (("config1", LSTM_CONFIG1), ("config3", LSTM_CONFIG3),
                       ("prefill", LSTM_PREFILL), ("ut_smem", LSTM_UT_SMEM),
                       ("slots", LSTM_SLOTS)):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in ((True,) if name == "prefill" else (False, True)):
            label = f"{name} B={B} T={T} H={H} mask={masked}"
            inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, masked,
                                                  seed=H + masked,
                                                  device=device)
            got = cl.lstm_forward(*inputs, save_residuals=True)
            bare = cl.lstm_forward(*inputs)
            ref = cl.lstm_forward_reference(*inputs, save_residuals=True)
            torch.cuda.synchronize()
            e = {}
            for n, a, r in zip(("ys", "hT", "cT", "z", "cs"), got, ref):
                e[n] = held(torch, n, a, r, label, scaled=n == "z")
            for n, a, r in zip(("ys", "hT", "cT"), bare, got):
                if not torch.equal(a, r):
                    fail(f"{label}: the forward without residuals gives "
                         f"other {n} than with them")
            # the backward from the plain forward's residuals and from the
            # kernel's own (what training feeds it)
            for src, (z, cs) in (("", ref[3:]), (" (kernel z, cs)", got[3:])):
                c_prev = torch.cat([inputs[3][None], cs[:-1]])
                bgot = cl.lstm_backward(z, inputs[3], cs, dys, inputs[1],
                                        dhT, dcT, inputs[4])
                bref = cl.lstm_backward_reference(z, c_prev, dys, inputs[1],
                                                  dhT, dcT, inputs[4])
                torch.cuda.synchronize()
                for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                    e[n + src] = held(torch, n, a, r, label + src,
                                      scaled=True)
            errs["fwd"] = max(errs["fwd"], *(e[n] for n in
                                             ("ys", "hT", "cT", "z", "cs")))
            errs["bwd"] = max(errs["bwd"], *(v for n, v in e.items()
                                             if n[:2] in ("dz", "dh", "dc")))
            print(f"  {label}: max |d| " + ", ".join(
                f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        print(f"  {name} plans: fwd {cl.plan('fwd', B, H, sms)}; bwd "
              f"(launched) {cl.card_plan('bwd', B, H, device)}", flush=True)

    # timing at config 1, the training path's shapes (forward with
    # residuals, no mask)
    B, T, H = LSTM_CONFIG1["B"], LSTM_CONFIG1["T"], LSTM_CONFIG1["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=device)
    _, _, _, z, cs = cl.lstm_forward(*inputs, save_residuals=True)
    fns = {
        "fwd": (lambda: cl.lstm_forward(*inputs, save_residuals=True),
                lambda: cl.lstm_forward_reference(*inputs,
                                                  save_residuals=True)),
        "bwd": (lambda: cl.lstm_backward(z, inputs[3], cs, dys, inputs[1],
                                         dhT, dcT),
                lambda: cl.lstm_backward_reference(
                    z, torch.cat([inputs[3][None], cs[:-1]]), dys, inputs[1],
                    dhT, dcT)),
    }
    lib_fwd, lib_bwd, lib_both, lib_diff, port_both = cudnn_yardstick(
        torch, cl.lstm_forward, cl.cuda_lstm_scan, inputs, (dys, dhT, dcT))
    print(f"  cuDNN torch.nn.LSTM (yardstick, input width {H}): forward "
          f"{lib_fwd:.4f} ms, backward alone {lib_bwd:.4f} ms, forward + "
          f"backward {lib_both:.4f} ms; its ys vs the forward kernel max |d| "
          f"{lib_diff:.2e}; the port's layer (both kernels and the matmuls "
          f"around them) forward + backward {port_both:.4f} ms", flush=True)
    timings = {}
    for kind, (kernel, plain) in fns.items():
        p1 = time_ms(torch, plain, 10)
        k1 = time_ms(torch, kernel, 100)
        k2 = time_ms(torch, kernel, 100)
        p2 = time_ms(torch, plain, 10)
        bound_ms, bound_by = lstm_bound(B, T, H, kind)
        prof = device_profile(torch, lambda: [kernel() for _ in range(20)])
        dev_ms = None
        if prof is not None:
            keys = [k for k in prof[2] if f"lstm_{kind}_kernel" in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                dev_ms = sum(prof[2][k] for k in keys) / n
        timings[kind] = dict(kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             bound_ms=bound_ms, bound_by=bound_by,
                             device_ms=dev_ms,
                             library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                             max_err=errs[kind])
        print(f"  lstm_{kind} config1: kernel_ms {timings[kind]['kernel_ms']:.4f}"
              f" ({k1:.4f}, {k2:.4f}; "
              f"{1e3 * timings[kind]['kernel_ms'] / T:.2f} us a step), "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {timings[kind]['plain_ms']:.4f} ({p1:.4f}, {p2:.4f}),"
              f" library_ms {timings[kind]['library_ms']:.4f} "
              f"({1e3 * timings[kind]['library_ms'] / T:.2f} us a step), "
              f"bound_ms {bound_ms:.6f} ({bound_by}); the T={T} dependent "
              "steps are a latency floor the bound does not see", flush=True)
    return timings


def train_phase(torch, cli, cl, device):
    print("== phase 6: train config 1 through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset, lm_windows

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    counters = {"fwd": cl.fwd_counts, "bwd": cl.bwd_counts}

    def run(name, extra):
        """One CLI run: its records and the launches of its capture
        warm-ups (see warmup_launches)."""
        path = os.path.join(tmp, f"{name}.jsonl")
        rc = cli.main(TRAIN_FLAGS + extra + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        return recs, warmup_launches(recs, counters)

    # the first steps on the card against the CPU's plain versions: 10 at
    # config 1, and 5 of a 2-layer stack (each layer through the kernels)
    first = {}
    for layers, n in ((1, 10), (2, 5)):
        for dev in ("cuda", "cpu"):
            cl.fwd_counts.reset()
            cl.bwd_counts.reset()
            recs, warm = run(f"first{n}_L{layers}_{dev}",
                             ["--num-steps", str(n), "--log-every", "1",
                              "--num-layers", str(layers), "--device", dev])
            first[layers, dev] = [r["loss"] for r in recs if "loss" in r]
            if len(first[layers, dev]) != n:
                fail(f"the {dev} run logged {len(first[layers, dev])} "
                     f"losses, not {n}")
            if dev == "cuda" and (cl.bwd_counts.kernel - warm["bwd"]
                                  != n * layers):
                fail(f"{layers}-layer card run: {cl.bwd_counts.kernel} "
                     f"backward launches ({warm['bwd']} in the capture's "
                     f"warm-up), not {n * layers} + the warm-up")
        a, b = first[layers, "cuda"], first[layers, "cpu"]
        gap = max(abs(x - y) for x, y in zip(a, b))
        print(f"  L={layers}, first {n} losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"{layers}-layer card losses differ from the CPU run by "
                 f"{gap:.3e} > {TRAIN_LOSS_TOL}")
    first_loss = first[1, "cuda"][0]

    # the main run: every LSTM layer forward and backward through the kernels
    data = get_dataset("ptb_char")
    valid = data["valid"]
    eval_bs = min(64, (len(valid) - 1) // 64)
    per_eval = min(EVAL_BATCHES, lm_windows(valid, eval_bs, 64)[2])
    n_evals = TRAIN_STEPS // EVAL_EVERY + 1  # the cadence, then the final
    layers = 1
    cl.fwd_counts.reset()
    cl.bwd_counts.reset()
    recs, warm = run("main", ["--num-steps", str(TRAIN_STEPS), "--log-every",
                              "50", "--eval-every", str(EVAL_EVERY),
                              "--eval-batches", str(EVAL_BATCHES),
                              "--device", "cuda"])
    launches = {"fwd": cl.fwd_counts.kernel, "bwd": cl.bwd_counts.kernel}
    plain = cl.fwd_counts.reference + cl.bwd_counts.reference
    expect = {"fwd": TRAIN_STEPS * layers + n_evals * per_eval * layers,
              "bwd": TRAIN_STEPS * layers}
    replayed = {k: launches[k] - warm[k] for k in launches}
    print(f"  kernel launches {launches}: {warm} in the capture's warm-up, "
          f"{replayed} in the replayed steps and the evals (expected "
          f"{expect}: {TRAIN_STEPS} steps x {layers} layer, + {n_evals} "
          f"evals x {per_eval} batches forward); plain runs {plain}",
          flush=True)
    if replayed != expect or plain != 0:
        fail(f"launch counts {replayed} (plain {plain}) != {expect}")
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not final.get("eval_ppl", 0) > 0:
        fail(f"the run did not end with a final eval record: {final}")
    if not logged[-1]["loss"] < first_loss:
        fail(f"the loss did not fall: {first_loss} -> {logged[-1]['loss']}")
    steady = sorted(r["steps_per_sec"] for r in logged[1:])
    tps = sorted(r["tokens_per_sec"] for r in logged[1:])
    sps, tok = steady[len(steady) // 2], tps[len(tps) // 2]
    print(f"  loss at step 1 {first_loss:.6f}, at step "
          f"{logged[-1]['step']} {logged[-1]['loss']:.6f}; final eval_loss "
          f"{final['eval_loss']:.6f}, eval_ppl {final['eval_ppl']:.4f}; "
          f"steady state (median of the log windows after the first) "
          f"{sps:.1f} steps/s, {tok:.1f} tokens/s", flush=True)

    # device idle share over 20 captured steps under torch.profiler, of the
    # run the CLI builds
    prof = device_profile(torch, config1_steps(cli))
    idle = None
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, _ = prof
        idle = 1 - busy / wall
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  20 steps under torch.profiler: device busy {busy:.3f} ms "
              f"of {wall:.3f} ms wall (idle share {idle:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
    return launches


def cli_calls(cli, flags, *, graph=True):
    """The run the CLI makes for ``flags`` (``cli.training``: the command's
    own model, state, train call and feed, built but not started), driven
    here call by call: ``calls(n)`` makes n more calls and returns the last
    one's metrics; ``calls.k`` is the optimizer steps a call takes."""
    run = cli.training(flags[1:], graph=graph)
    state, feed = [run.state], iter(run.feed)

    def calls(n):
        m = None
        for _ in range(n):
            state[0], m = run.step(state[0], next(feed))
        return m

    calls.k = run.loop_kw["steps_per_call"]
    return calls


def cli_steps(cli, flags, n=20):
    """A function that makes ``n`` more calls of the run the CLI makes for
    ``flags`` (:func:`cli_calls`), after 5 (the first captures)."""
    calls = cli_calls(cli, flags)
    calls(5)
    return lambda: calls(n)


def config1_steps(cli, n=20):
    """Config 1's training (``TRAIN_FLAGS`` on the card) as the CLI wires
    it: :func:`cli_steps`."""
    return cli_steps(cli, TRAIN_FLAGS + ["--device", "cuda"], n)


def imdb_lengths(B, T):
    """The lengths of the IMDB stand-in's first config-2 training batch
    (shuffle seed 0, length buckets): what the kernels' mask sees."""
    from lstm_tensorspark_torch.data import get_dataset, padded_batches

    seqs, labels = get_dataset("imdb", max_len=T)["train"]
    return next(padded_batches(seqs, labels, B, T, shuffle_seed=0))["lengths"]


def lstmx_inputs(torch, B, T, D, H, ndir, lengths, seed, device):
    """Seeded direction-stacked inputs of the residentx pair — xs, W, b, U,
    h0, c0, mask (or None) — and the backward's cotangents dys, dhT, dcT,
    on ``device``. With ``lengths`` each direction's rows are right-padded
    to them; the second direction's mask is time-flipped, as the bi-LSTM
    layer feeds it."""
    g = torch.Generator().manual_seed(seed)
    BS, G = ndir * B, 4 * H
    xs = torch.randn(T, BS, D, generator=g)
    W = torch.randn(ndir, D, G, generator=g) / D ** 0.5
    b = torch.randn(ndir, G, generator=g) * 0.1
    U = torch.randn(ndir, H, G, generator=g) / H ** 0.5
    h0 = torch.randn(BS, H, generator=g) * 0.5
    c0 = torch.randn(BS, H, generator=g) * 0.5
    mask = None
    if lengths is not None:
        m = (torch.arange(T)[:, None]
             < torch.as_tensor(lengths)[None, :]).float()
        mask = m if ndir == 1 else torch.cat([m, torch.flip(m, dims=(0,))], 1)
    dys = torch.randn(T, BS, H, generator=g)
    dhT = torch.randn(BS, H, generator=g)
    dcT = torch.randn(BS, H, generator=g)

    def dev(t):
        return None if t is None else t.to(device).contiguous()

    return ([dev(t) for t in (xs, W, b, U, h0, c0, mask)],
            [dev(t) for t in (dys, dhT, dcT)])


def lstmx_bound(B, T, D, H, ndir, kind, masked, save_c=True, esize=4):
    """Least time of one call of the pair: the larger of the bytes it must
    move (each input read once, each output written once) over HBM
    bandwidth and its products' FLOPs over the card's peak. The forward
    (with ``save_c``: its cs writes) does the projection and h @ U,
    2·T·BS·(D+H)·4H; the backward rebuilds z (the same) and does dz @ Uᵀ,
    2·T·BS·4H·H. ``esize`` 2 is the bfloat16 form: xs, W, U and dz at 2
    bytes, the rest at 4, the products at the bfloat16 tensor-core peak."""
    BS, G = ndir * B, 4 * H
    narrow = T * BS * D + ndir * (D * G + H * G)  # xs, W, U
    wide = ndir * G + (T * BS if masked else 0)  # b, mask
    if kind == "fwd":  # h0, c0 in; ys, hT, cT (and cs) out
        wide += 2 * BS * H + T * BS * H + 2 * BS * H \
            + (T * BS * H if save_c else 0)
        flops = 2 * T * BS * (D + H) * G
    else:  # ys, h0, cs, c0, dys, dhT, dcT in; dz, dh0, dc0 out
        wide += 3 * T * BS * H + 4 * BS * H + 2 * BS * H
        narrow += T * BS * G
        flops = 2 * T * BS * (D + H) * G + 2 * T * BS * G * H
    nbytes = esize * narrow + 4 * wide
    peak = PEAK_F32_FLOPS if esize == 4 else PEAK_BF16_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_bi_yardstick(torch, B, T, D, H, ndir, device, dtype=None):
    """cuDNN's ``torch.nn.LSTM`` (bidirectional when ``ndir`` is 2) on one
    layer at the same B, T, D, H, unmasked, TF32 off, in ``dtype`` (float32
    by default): (forward ms, backward alone ms). It does more than the
    kernels — its forward includes the input product for both directions'
    inputs, its backward also gives dx, dW, dU and db — so it is a
    yardstick, not a like-for-like time; the port never calls it."""
    dtype = dtype or torch.float32
    lstm = torch.nn.LSTM(D, H, bidirectional=ndir == 2).to(device, dtype)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(T, B, D, generator=g).to(device, dtype).requires_grad_()
    dy = torch.randn(T, B, ndir * H, generator=g).to(device, dtype)
    ys, _ = lstm(x)

    def fwd():
        return lstm(x)

    def bwd():
        return torch.autograd.grad(ys, [x, *lstm.parameters()], dy,
                                   retain_graph=True)

    return time_ms(torch, fwd, 20), time_ms(torch, bwd, 20)


# Each role is timed at the shape of the run its launches on the main path
# come from (phase 8): the one-direction forward as config 2 runs it under
# --remat-chunk 50 (inside the recompute Function, so without cs), the
# one-direction backward in the LM at --seq-len 256, the stacked pair in
# config 2's main run (the forward of a training step, with cs).
# each kernel's side kernel, timed apart from its chain: the forward's
# projection (zx), the backward's z rebuild
LSTMX_SIDE = {"fwd": "lstmx_proj_kernel", "bwd": "lstmx_factors_kernel"}
LSTMX_SHAPES = {"config2": CONFIG2, "lm256": LM256, "awkward": AWKWARD,
                "awkward8": AWKWARD8, "lm8": LM8, "smem": LSTMX_SMEM,
                "l2": LSTMX_L2, "tiny": LSTMX_TINY, "small": LSTMX_SMALL}


def lstmx_lengths(lens, lens2):
    """A case's row lengths: ``"imdb"`` the IMDB stand-in's first config-2
    batch (``lens2``), ``"awkward"`` / ``"awkward8"`` right padding of
    every kind at those shapes, a list as given, None unmasked."""
    if lens == "imdb":
        return lens2
    if lens == "awkward":
        out = [AWKWARD["T"] - 3 * i for i in range(AWKWARD["B"])]
        out[-1] = 1
        return out
    if lens == "awkward8":
        return [AWKWARD8["T"] - i for i in range(AWKWARD8["B"])]
    return lens
LSTMX_ROLES = {  # role: (shape, ndir, kind, masked, save_c)
    "lstmx_fwd": ("config2", 1, "fwd", True, False),
    "lstmx_bwd": ("lm256", 1, "bwd", False, True),
    "bilstm_fwd": ("config2", 2, "fwd", True, True),
    "bilstm_bwd": ("config2", 2, "bwd", True, True),
}


def lstmx_kernel_phase(torch, cx, device):
    print("== phase 7: residentx kernels (one and two directions) vs plain "
          "versions", flush=True)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    B2, T2, D2, H2 = (CONFIG2[k] for k in ("B", "T", "D", "H"))
    lens2 = imdb_lengths(B2, T2)
    print(f"  IMDB stand-in lengths of the first config-2 batch: min "
          f"{int(lens2.min())}, max {int(lens2.max())}, mean "
          f"{float(lens2.mean()):.1f}", flush=True)
    shapes = LSTMX_SHAPES
    lens_aw, lens_aw8 = (lstmx_lengths(n, lens2)
                         for n in ("awkward", "awkward8"))
    cases = []
    for ndir in (1, 2):
        cases += [("config2", ndir, lens2), ("config2", ndir, None)]
        if ndir == 1:
            cases.append(("lm256", 1, None))
        cases.append(("awkward", ndir, lens_aw))
    cases += [("awkward8", 2, lens_aw8), ("lm8", 2, None),
              ("smem", 2, None), ("l2", 1, None), ("tiny", 1, [5, 1, 3]),
              ("small", 2, [9, 1, 5, 9, 7, 2, 6, 3])]
    errs = {("fwd", 1): 0.0, ("bwd", 1): 0.0, ("fwd", 2): 0.0, ("bwd", 2): 0.0}
    for i, (name, ndir, lens) in enumerate(cases):
        B, T, D, H = (shapes[name][k] for k in ("B", "T", "D", "H"))
        label = (f"{name} B={B} T={T} D={D} H={H} ndir={ndir} "
                 f"mask={lens is not None}")
        inputs, (dys, dhT, dcT) = lstmx_inputs(torch, B, T, D, H, ndir, lens,
                                               seed=20 + i, device=device)
        xs, W, b, U, h0, c0, mask = inputs
        got = cx.lstmx_forward(*inputs, save_c=True)
        bare = cx.lstmx_forward(*inputs)
        ref = cx.lstmx_forward_reference(*inputs, save_c=True)
        torch.cuda.synchronize()
        e = {}
        for n, a, r in zip(("ys", "hT", "cT", "cs"), got, ref):
            e[n] = held(torch, n, a, r, label, scaled=False)
        for n, a, r in zip(("ys", "hT", "cT"), bare, got):
            if not torch.equal(a, r):
                fail(f"{label}: the forward without cs gives other {n} than "
                     "with it")
        # the backward from the plain forward's ys and cs, then from the
        # kernel's own
        for fed, (ys, cs) in (("", (ref[0], ref[3])),
                              (" (own)", (got[0], got[3]))):
            bgot = cx.lstmx_backward(xs, ys, h0, cs, c0, dys, W, b, U, dhT,
                                     dcT, mask)
            bref = cx.lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b,
                                               U, dhT, dcT, mask)
            torch.cuda.synchronize()
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n + fed] = held(torch, n, a, r, label + fed, scaled=True)
        errs["fwd", ndir] = max(errs["fwd", ndir],
                                *(e[n] for n in ("ys", "hT", "cT", "cs")))
        errs["bwd", ndir] = max(errs["bwd", ndir], *(
            v for n, v in e.items() if n.split()[0] in ("dz", "dh0", "dc0")))
        print(f"  {label}: max |d| " + ", ".join(
            f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        print(f"    plan {cx.card_plan(B, H, D, ndir, device)}", flush=True)

    timings = {}
    lib = {}
    for role, (name, nd, kind, masked, save_c) in LSTMX_ROLES.items():
        B, T, D, H = (shapes[name][k] for k in ("B", "T", "D", "H"))
        if (name, nd) not in lib:
            lib[name, nd] = cudnn_bi_yardstick(torch, B, T, D, H, nd, device)
            print(f"  cuDNN torch.nn.LSTM{' bidirectional' if nd == 2 else ''}"
                  f" (yardstick; also the input product, dx and the weight "
                  f"gradients) {name} B={B} T={T} D={D} H={H}: forward "
                  f"{lib[name, nd][0]:.4f} ms, backward alone "
                  f"{lib[name, nd][1]:.4f} ms", flush=True)
        inputs, (dys, dhT, dcT) = lstmx_inputs(
            torch, B, T, D, H, nd, lens2 if masked else None, seed=7,
            device=device)
        xs, W, b, U, h0, c0, mask = inputs
        ys, _, _, cs = cx.lstmx_forward(*inputs, save_c=True)
        bargs = (xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
        if kind == "fwd":
            def kernel():
                return cx.lstmx_forward(*inputs, save_c=save_c)

            def plain():
                return cx.lstmx_forward_reference(*inputs, save_c=save_c)
        else:
            def kernel():
                return cx.lstmx_backward(*bargs)

            def plain():
                return cx.lstmx_backward_reference(*bargs)
        p1 = time_ms(torch, plain, 2)
        k1 = time_ms(torch, kernel, 10)
        k2 = time_ms(torch, kernel, 10)
        p2 = time_ms(torch, plain, 2)
        bound_ms, bound_by = lstmx_bound(B, T, D, H, nd, kind, masked, save_c)
        prof = device_profile(torch, lambda: [kernel() for _ in range(10)])
        dev_ms = side_ms = None
        if prof is not None:
            keys = [k for k in prof[2] if f"lstmx_{kind}_kernel" in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                dev_ms = sum(prof[2][k] for k in keys) / n
            keys = [k for k in prof[2] if LSTMX_SIDE[kind] in k]
            n = sum(prof[3][k] for k in keys)
            if n:
                side_ms = sum(prof[2][k] for k in keys) / n
        timings[role] = dict(
            kernel_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
            bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms,
            library_ms=lib[name, nd][0 if kind == "fwd" else 1],
            max_err=errs[kind, nd])
        both = (f" (the chain; its "
                f"{'projection' if kind == 'fwd' else 'z rebuild'} "
                + ("not measured" if side_ms is None else f"{side_ms:.4f}")
                + ")")
        print(f"  {role} {name} B={B} T={T} D={D} H={H} (mask={masked}, "
              f"cs={save_c if kind == 'fwd' else 'in'}): kernel_ms "
              f"{timings[role]['kernel_ms']:.4f} ({k1:.4f}, {k2:.4f}; "
              f"{1e3 * timings[role]['kernel_ms'] / T:.2f} us a step), "
              f"device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}"
              f"{both}, plain_ms {timings[role]['plain_ms']:.4f} ({p1:.4f}, "
              f"{p2:.4f}), library_ms {timings[role]['library_ms']:.4f} "
              f"({1e3 * timings[role]['library_ms'] / T:.2f} us a step), "
              f"bound_ms {bound_ms:.6f} ({bound_by})", flush=True)
    rows_ab(torch, cx, lens2, sms, device)
    return timings


def rows_ab(torch, cx, lens2, sms, device):
    """The stacked pair at config 2 under the card's plan and under the
    other row cut of each kernel, alternated with CUDA events: the forward
    with 4-row clusters (16 of them: more than the card keeps at once, and
    their 128 SMs leave the projection too few, so it runs first), and
    the backward with the cut for every SM (its card plan takes 8-row
    clusters, one wave).
    The forward's results must not change by a bit (none of its sums
    depends on the rows); the backward's dz @ Uᵀ split follows its rows,
    so under either cut its dz, dh0, dc0 are held against the plain
    version with the phase's tolerance."""
    B2, T2, D2, H2 = (CONFIG2[k] for k in ("B", "T", "D", "H"))
    inputs, (dys, dhT, dcT) = lstmx_inputs(torch, B2, T2, D2, H2, 2, lens2,
                                           seed=7, device=device)
    xs, W, b, U, h0, c0, mask = inputs
    card = cx.card_plan(B2, H2, D2, 2, device)
    alt = {"fwd": card._replace(fwd=cx.forward_plan(B2, H2, 8)),
           "bwd": card._replace(bwd=cx.plan(B2, H2, D2, 2, sms).bwd)}
    ys, _, _, cs = cx.lstmx_forward(*inputs, save_c=True)
    bargs = (xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
    calls = {"fwd": lambda p: cx.lstmx_forward(*inputs, save_c=True, xplan=p),
             "bwd": lambda p: cx.lstmx_backward(*bargs, xplan=p)}
    bref = cx.lstmx_backward_reference(*bargs)
    parts, bwd_err = [], 0.0
    for kind in ("fwd", "bwd"):
        a, o = getattr(card, kind), getattr(alt[kind], kind)
        got, other = calls[kind](card), calls[kind](alt[kind])
        if kind == "fwd":
            if not all(torch.equal(x, y) for x, y in zip(got, other)):
                fail("bilstm_fwd: the row cut changed the results")
        else:
            for p, out in (("card plan", got), ("other cut", other)):
                for n, x, r in zip(("dz", "dh0", "dc0"), out, bref):
                    bwd_err = max(bwd_err, held(
                        torch, n, x, r, f"bilstm_bwd row cut ({p})", True))
        t = {p: [] for p in ("card", "alt")}
        for p in ("card", "alt", "alt", "card"):
            pl = card if p == "card" else alt[kind]
            t[p].append(time_ms(torch, lambda: calls[kind](pl), 10))
        parts.append(
            f"{kind} card plan {a.rows} rows ({a.groups * 2} clusters, chunk "
            f"{a.chunk}) {sum(t['card']) / 2:.4f} ms ({t['card'][0]:.4f}, "
            f"{t['card'][1]:.4f}) vs {o.rows} rows ({o.groups * 2} clusters, "
            f"chunk {o.chunk}) {sum(t['alt']) / 2:.4f} ms ({t['alt'][0]:.4f}, "
            f"{t['alt'][1]:.4f})")
    print(f"  row cut of the stacked pair at config 2 (the card keeps "
          f"{cx.max_clusters(device, card.cluster)} clusters of "
          f"{card.cluster}; forward results bit-equal, backward within "
          f"{bwd_err:.2e} of the plain version): " + "; ".join(parts),
          flush=True)


def config2_phase(torch, cli, cl, cx, ct, device, host):
    print("== phase 8: train config 2 through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset

    tmp = tempfile.mkdtemp(prefix="chip_smoke_config2_")
    counters = all_counters(cl, cx, ct)
    warmups = {}

    def run(name, flags):
        """One CLI run with every count set to 0 just before it; returns
        its records and the kernel launches it made (plain runs under
        'plain')."""
        for c in counters.values():
            c.reset()
        path = os.path.join(tmp, f"{name}.jsonl")
        rc = cli.main(flags + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        # the replayed steps' and evals' launches: the capture's warm-up
        # launches are taken out, kept in warmups and printed
        warm = warmups[name] = warmup_launches(recs, counters)
        launches = {k: c.kernel - warm[k] for k, c in counters.items()}
        launches["plain"] = sum(c.reference for c in counters.values())
        if any(warm.values()):
            print(f"    {name}: capture warm-up launches "
                  f"{ {k: v for k, v in warm.items() if v} }", flush=True)
        return recs, launches

    def expect(got, name, **want):
        full = {k: 0 for k in counters}
        full.update(want)
        full["plain"] = 0
        if got != full:
            fail(f"{name}: launch counts {got} != predicted {full}")

    # the CPU reference runs once, without remat (a host run beside the
    # card, HostRuns): with --remat-chunk the plain scan gives the same
    # values (tests/test_torch_scan_routes.py), so both card runs are held
    # against it
    first, rate = {}, {}
    n = CONFIG2_FIRST
    for remat in (None, 50):
        extra = [] if remat is None else ["--remat-chunk", str(remat)]
        name = f"first{n}_remat{remat}_cuda"
        t0 = time.perf_counter()
        recs, launches = run(name, first_flags(CONFIG2_FLAGS + extra, n)
                             + ["--device", "cuda"])
        first[remat] = [r["loss"] for r in recs if "loss" in r]
        # steps/s a step (log-every 1), the median of steps 2-n
        sps = sorted(r["steps_per_sec"] for r in recs
                     if "loss" in r and r["step"] > 1)
        rate[remat] = sps[len(sps) // 2] if sps else float("nan")
        # n steps and one eval batch; with remat each direction is its own
        # scan and the backward is the plain recompute
        if remat is None:
            expect(launches, name, bilstm_fwd=n + 1, bilstm_bwd=n)
        else:
            expect(launches, name, lstmx_fwd=2 * (n + 1))
            remat_launches = launches
        print(f"  {name}: {time.perf_counter() - t0:.1f} s, launches "
              f"{launches}", flush=True)
        a, b = first[remat], host.losses(*host_references()[0])
        if len(a) != n or len(b) != n:
            fail(f"{name}: logged {len(a)} losses, the CPU run {len(b)}, "
                 f"not {n}")
        gap = max(abs(x - y) for x, y in zip(a, b))
        route = ("the stacked pair" if remat is None else
                 "the residentx forward a direction, then the plain "
                 "recompute backward")
        print(f"  remat_chunk={remat}, first {n} losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}; {rate[remat]:.2f} steps/s on the "
              f"card (median of steps 2-{n}, {route})", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"config 2 (remat_chunk={remat}) card losses differ from "
                 f"the CPU run by {gap:.3e} > {TRAIN_LOSS_TOL}")

    # the main run: every bi-layer forward and backward through the stacked
    # kernels, dropout on
    valid = get_dataset("imdb", max_len=CONFIG2["T"])["valid"][0]
    per_eval = -(-len(valid) // CONFIG2["B"])  # filler rows pad the last
    n_evals = CONFIG2_STEPS // CONFIG2_EVAL_EVERY + 1
    recs, launches = run("main", CONFIG2_FLAGS + [
        "--num-steps", str(CONFIG2_STEPS), "--log-every", "50",
        "--eval-every", str(CONFIG2_EVAL_EVERY), "--dropout", "0.2",
        "--device", "cuda"])
    want = dict(bilstm_fwd=CONFIG2_STEPS + n_evals * per_eval,
                bilstm_bwd=CONFIG2_STEPS)
    print(f"  kernel launches {launches} (predicted {want}: {CONFIG2_STEPS} "
          f"steps, + {n_evals} evals x {per_eval} batches forward)",
          flush=True)
    expect(launches, "main", **want)
    main_launches = launches
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not 0.0 <= final.get(
            "eval_accuracy", -1.0) <= 1.0:
        fail(f"the run did not end with a final eval record: {final}")
    if not all(r["loss"] == r["loss"] and r["loss"] < 1e9 for r in logged):
        fail("a logged loss is not finite")
    sps = sorted(r["steps_per_sec"] for r in logged[1:])
    eps = sorted(r["examples_per_sec"] for r in logged[1:])
    print(f"  loss at step 1 {first[None][0]:.6f} (dropout 0 run), "
          f"at step {logged[0]['step']} {logged[0]['loss']:.6f}, at step "
          f"{logged[-1]['step']} {logged[-1]['loss']:.6f}; final eval_loss "
          f"{final['eval_loss']:.6f}, eval_accuracy "
          f"{final['eval_accuracy']:.4f}; steady state (median of the log "
          f"windows after the first) {sps[len(sps) // 2]:.2f} steps/s, "
          f"{eps[len(eps) // 2]:.1f} examples/s", flush=True)

    # the LM at T=256: the single-direction residentx pair
    lm = {}
    for dev in ("cuda", "cpu"):
        recs, launches = run(f"lm256_{dev}", TRAIN_FLAGS + [
            "--seq-len", "256", "--num-steps", str(n), "--log-every", "1",
            "--eval-batches", "1", "--device", dev])
        lm[dev] = [r["loss"] for r in recs if "loss" in r]
        if dev == "cuda":
            expect(launches, "lm256_cuda", lstmx_fwd=n + 1, lstmx_bwd=n)
            lm_launches = launches
    gap = max(abs(x - y) for x, y in zip(lm["cuda"], lm["cpu"]))
    print(f"  LM at --seq-len 256, first {n} losses: card "
          f"{[round(x, 6) for x in lm['cuda']]}; CPU "
          f"{[round(x, 6) for x in lm['cpu']]}; max |d| {gap:.2e}; launches "
          f"{lm_launches}", flush=True)
    if len(lm["cuda"]) != n or not gap <= TRAIN_LOSS_TOL:
        fail(f"LM at T=256: card losses differ from the CPU run by {gap:.3e}")

    # device idle share over 20 config-2 steps under torch.profiler, of the
    # run the CLI builds
    twenty = cli_steps(cli, CONFIG2_FLAGS + ["--dropout", "0.2", "--device",
                                             "cuda"])
    prof = device_profile(torch, twenty)
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, _ = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"  20 config-2 steps under torch.profiler: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
    # the launches each run made, its capture's warm-up included
    return {"lstmx_fwd": (remat_launches["lstmx_fwd"]
                          + warmups[f"first{n}_remat50_cuda"]["lstmx_fwd"]),
            "lstmx_bwd": (lm_launches["lstmx_bwd"]
                          + warmups["lm256_cuda"]["lstmx_bwd"]),
            "bilstm_fwd": (main_launches["bilstm_fwd"]
                           + warmups["main"]["bilstm_fwd"]),
            "bilstm_bwd": (main_launches["bilstm_bwd"]
                           + warmups["main"]["bilstm_bwd"])}


def all_counters(cl, cx, ct):
    """Every recurrence kernel's launch counter, by kernel name (the
    bfloat16 forms' too)."""
    return {"lstm_fwd": cl.fwd_counts, "lstm_bwd": cl.bwd_counts,
            "lstmx_fwd": cx.fwdx_counts, "lstmx_bwd": cx.bwdx_counts,
            "bilstm_fwd": cx.bi_fwdx_counts, "bilstm_bwd": cx.bi_bwdx_counts,
            "lstm_tiled_fwd": ct.fwd_counts, "lstm_tiled_bwd": ct.bwd_counts,
            "lstm_fwd_bf16": cl.fwd_bf16_counts,
            "lstm_bwd_bf16": cl.bwd_bf16_counts,
            "lstm_tiled_fwd_bf16": ct.fwd_bf16_counts,
            "lstm_tiled_bwd_bf16": ct.bwd_bf16_counts,
            "lstmx_fwd_bf16": cx.fwdx_bf16_counts,
            "lstmx_bwd_bf16": cx.bwdx_bf16_counts,
            "bilstm_fwd_bf16": cx.bi_fwdx_bf16_counts,
            "bilstm_bwd_bf16": cx.bi_bwdx_bf16_counts}


def warmup_launches(recs, counters):
    """The launches the capture warm-ups of a CLI run made, by counter key:
    each ``graph capture`` record's warm-up calls times the launches its
    capture recorded (a warm-up call is the captured body run eagerly).
    The rest of a run's launches are its replays' and its eager evals'."""
    caps = [r for r in recs if r.get("note") == "graph capture"]
    return {k: sum(r["warmup_calls"] * r["launches"].get(c.name, 0)
                   for r in caps) for k, c in counters.items()}


def in_turns(torch, first, second, iters):
    """(first ms, second ms), each the mean of two CUDA-event timings taken
    in turns (first, second, second, first), and the four readings."""
    a1 = time_ms(torch, first, iters)
    b1 = time_ms(torch, second, iters)
    b2 = time_ms(torch, second, iters)
    a2 = time_ms(torch, first, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def profiled_ms(torch, fn, name, calls):
    """Device ms per launch of kernel ``name`` under ``torch.profiler`` over
    ``calls`` calls of ``fn``, or None when the profiler records none."""
    prof = device_profile(torch, lambda: [fn() for _ in range(calls)])
    if prof is None:
        return None
    keys = [k for k in prof[2] if name in k]
    n = sum(prof[3][k] for k in keys)
    return sum(prof[2][k] for k in keys) / n if n else None


def tiled_kernel_phase(torch, cl, ct, device):
    print("== phase 9: tiled LSTM kernels vs plain versions", flush=True)
    from lstm_tensorspark_torch import kernels

    errs = {"fwd": 0.0, "bwd": 0.0}
    print(f"  resident clusters at one block an SM: "
          f"{ct.max_clusters(device)}", flush=True)
    regs = {name: ", ".join(form_registers(kernels, name, bf16=False))
            or "not reported" for name in ("lstm_tiled_fwd", "lstm_tiled_bwd")}
    for name, spec in (("config5", LSTM_CONFIG5), ("config5-b64", LSTM_B64),
                       ("b256", LSTM_B256), ("config3", LSTM_CONFIG3),
                       ("awkward", LSTM_TILED_AWKWARD),
                       ("narrow", LSTM_TILED_NARROW)):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in (False, True):
            label = f"{name} B={B} T={T} H={H} mask={masked}"
            inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, masked,
                                                  seed=B + H + masked,
                                                  device=device)
            got = ct.lstm_tiled_forward(*inputs, save_residuals=True)
            bare = ct.lstm_tiled_forward(*inputs)
            ref = cl.lstm_forward_reference(*inputs, save_residuals=True)
            torch.cuda.synchronize()
            e = {}
            for n, a, r in zip(("ys", "hT", "cT", "z", "cs"), got, ref):
                e[n] = held(torch, n, a, r, label, scaled=n == "z")
            for n, a, r in zip(("ys", "hT", "cT"), bare, got):
                if not torch.equal(a, r):
                    fail(f"{label}: the tiled forward without residuals "
                         f"gives other {n} than with them")
            ys, hT, cT, z, cs = ref
            c_prev = torch.cat([inputs[3][None], cs[:-1]])
            bgot = ct.lstm_tiled_backward(z, inputs[3], cs, dys, inputs[1],
                                          dhT, dcT, inputs[4])
            bref = cl.lstm_backward_reference(z, c_prev, dys, inputs[1], dhT,
                                              dcT, inputs[4])
            torch.cuda.synchronize()
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n] = held(torch, n, a, r, label, scaled=True)
            errs["fwd"] = max(errs["fwd"], *(e[n] for n in
                                             ("ys", "hT", "cT", "z", "cs")))
            errs["bwd"] = max(errs["bwd"], e["dz"], e["dh0"], e["dc0"])
            print(f"  {label}: max |d| " + ", ".join(
                f"{n} {v:.2e}" for n, v in e.items()), flush=True)
        for kind in ("fwd", "bwd"):
            p = ct.card_plan(kind, B, H, device)
            print(f"  {name} tiled {kind} plan: {p.blocks} blocks of "
                  f"{ct.THREADS} threads in clusters of {p.cluster}, "
                  f"{p.units} units a block, {p.row_tiles} row tiles, "
                  f"{p.groups} groups of {p.group_lanes} lanes, {p.per_lane} "
                  f"{'rows' if kind == 'fwd' else 'columns'} of U a lane "
                  f"({p.u_regs} in registers), {regs[f'lstm_tiled_{kind}']} "
                  f"a thread, {p.smem_bytes} bytes of shared memory a block",
                  flush=True)

    # timing at config 5's shard, the training path's shapes (forward with
    # residuals, unmasked)
    B, T, H = LSTM_CONFIG5["B"], LSTM_CONFIG5["T"], LSTM_CONFIG5["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=device)
    _, _, _, z, cs = ct.lstm_tiled_forward(*inputs, save_residuals=True)
    c_prev = torch.cat([inputs[3][None], cs[:-1]])
    bargs = (z, inputs[3], cs, dys, inputs[1], dhT, dcT)
    fns = {
        "fwd": (lambda: ct.lstm_tiled_forward(*inputs, save_residuals=True),
                lambda: cl.lstm_forward_reference(*inputs,
                                                  save_residuals=True)),
        "bwd": (lambda: ct.lstm_tiled_backward(*bargs),
                lambda: cl.lstm_backward_reference(
                    z, c_prev, dys, inputs[1], dhT, dcT)),
    }
    lib_fwd, lib_bwd, lib_both, lib_diff, port_both = cudnn_yardstick(
        torch, ct.lstm_tiled_forward, ct.cuda_lstm_tiled_scan, inputs,
        (dys, dhT, dcT))
    print(f"  cuDNN torch.nn.LSTM (yardstick, input width {H}) at config "
          f"5's shard B={B} T={T} H={H}: forward {lib_fwd:.4f} ms, backward "
          f"alone {lib_bwd:.4f} ms, forward + backward {lib_both:.4f} ms; its"
          f" ys vs the tiled forward max |d| {lib_diff:.2e}; the port's layer"
          f" (both tiled kernels and the matmuls around them) forward + "
          f"backward {port_both:.4f} ms", flush=True)
    timings = {}
    for kind, (kernel, plain) in fns.items():
        plain_ms, kernel_ms, r = in_turns(torch, plain, kernel, 5)
        bound_ms, bound_by = lstm_bound(B, T, H, kind)
        dev_ms = profiled_ms(torch, kernel, f"lstm_tiled_{kind}_kernel", 20)
        timings[kind] = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             device_ms=dev_ms,
                             library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                             max_err=errs[kind])
        print(f"  lstm_tiled_{kind} config5: kernel_ms {kernel_ms:.4f} "
              f"({r[1]:.4f}, {r[2]:.4f}; {1e3 * kernel_ms / T:.2f} us a "
              f"step), device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {plain_ms:.4f} ({r[0]:.4f}, {r[3]:.4f}), library_ms "
              f"{timings[kind]['library_ms']:.4f}, bound_ms {bound_ms:.6f} "
              f"({bound_by}, {kernel_ms / bound_ms:.1f}x); the parent design "
              f"{TILED_PARENT_MS[kind]:.4f} ms (PERF.md); the T={T} dependent "
              "steps are a latency floor the bound does not see", flush=True)

    # the route at config 3's width: the tiled pair against the resident
    # pair (U read through L2 there), in turns
    B, T, H = LSTM_CONFIG3["B"], LSTM_CONFIG3["T"], LSTM_CONFIG3["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=3,
                                          device=device)
    _, _, _, z, cs = ct.lstm_tiled_forward(*inputs, save_residuals=True)
    bargs = (z, inputs[3], cs, dys, inputs[1], dhT, dcT)
    parts = []
    for kind, res, til in (
            ("fwd", lambda: cl.lstm_forward(*inputs, save_residuals=True),
             lambda: ct.lstm_tiled_forward(*inputs, save_residuals=True)),
            ("bwd", lambda: cl.lstm_backward(*bargs),
             lambda: ct.lstm_tiled_backward(*bargs))):
        res_ms, til_ms, r = in_turns(torch, res, til, 10)
        parts.append(f"{kind} resident {res_ms:.4f} ms ({r[0]:.4f}, "
                     f"{r[3]:.4f}) vs tiled {til_ms:.4f} ms ({r[1]:.4f}, "
                     f"{r[2]:.4f})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    print(f"  route at config 3's width B={B} T={T} H={H} (resident plan "
          f"keeps U in shared memory: {cl.plan('fwd', B, H, sms).smem_w}): "
          + "; ".join(parts), flush=True)
    return timings


def config5_phase(torch, cli, cl, cx, ct, device):
    print("== phase 10: train config 5's model through the CLI", flush=True)
    from lstm_tensorspark_torch.data import get_dataset, lm_windows

    tmp = tempfile.mkdtemp(prefix="chip_smoke_config5_")
    counters = all_counters(cl, cx, ct)
    warmups = {}

    def run(name, flags):
        """One CLI run with every count set to 0 just before it; returns
        its records and the kernel launches it made (plain runs under
        'plain')."""
        for c in counters.values():
            c.reset()
        path = os.path.join(tmp, f"{name}.jsonl")
        t0 = time.perf_counter()
        rc = cli.main(flags + ["--jsonl", path])
        if rc != 0:
            fail(f"train run {name} exited {rc}")
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        # the replayed steps' and evals' launches: the capture's warm-up
        # launches are taken out, kept in warmups and printed
        warm = warmups[name] = warmup_launches(recs, counters)
        launches = {k: c.kernel - warm[k] for k, c in counters.items()}
        launches["plain"] = sum(c.reference for c in counters.values())
        print(f"  {name}: {time.perf_counter() - t0:.1f} s; capture warm-up "
              f"launches { {k: v for k, v in warm.items() if v} }",
              flush=True)
        return recs, launches

    def expect(got, name, **want):
        full = {k: 0 for k in counters}
        full.update(want)
        full["plain"] = 0
        if got != full:
            fail(f"{name}: launch counts {got} != predicted {full}")

    L, n = CONFIG5["L"], CONFIG5_FIRST
    # the CPU reference runs once, without remat: with --remat-chunk the
    # plain scan gives the same values, so both card runs are held to it
    first = {}
    for remat, dev in ((None, "cuda"), (None, "cpu"), (32, "cuda")):
        extra = [] if remat is None else ["--remat-chunk", str(remat)]
        name = f"first{n}_remat{remat}_{dev}"
        recs, launches = run(name, CONFIG5_FLAGS + extra + [
            "--num-steps", str(n), "--log-every", "1", "--dropout", "0",
            "--eval-batches", "1", "--device", dev])
        first[remat, dev] = [r["loss"] for r in recs if "loss" in r]
        if len(first[remat, dev]) != n:
            fail(f"{name} logged {len(first[remat, dev])} losses, not {n}")
        if dev == "cuda":
            # n steps and one eval batch, every layer through the tiled
            # forward; without remat the tiled backward, with it the plain
            # recompute
            expect(launches, name, lstm_tiled_fwd=(n + 1) * L,
                   lstm_tiled_bwd=0 if remat else n * L)
            print(f"    launches {launches}", flush=True)
    for remat in (None, 32):
        a, b = first[remat, "cuda"], first[None, "cpu"]
        gap = max(abs(x - y) for x, y in zip(a, b))
        print(f"  remat_chunk={remat}, first 10 losses: card "
              f"{[round(x, 6) for x in a]}; CPU {[round(x, 6) for x in b]}; "
              f"max |d| {gap:.2e}", flush=True)
        if not gap <= TRAIN_LOSS_TOL:
            fail(f"config 5 (remat_chunk={remat}) card losses differ from "
                 f"the CPU run by {gap:.3e} > {TRAIN_LOSS_TOL}")

    # the main run: dropout 0.2, an eval cadence; every layer of every step
    # and eval batch through the tiled pair
    valid = get_dataset("wikitext103")["valid"]
    B, T = CONFIG5["B"], CONFIG5["T"]
    per_eval = min(CONFIG5_EVAL_BATCHES, lm_windows(valid, B, T)[2])
    n_evals = CONFIG5_STEPS // CONFIG5_EVAL_EVERY + 1  # the cadence, final
    recs, launches = run("main", CONFIG5_FLAGS + [
        "--num-steps", str(CONFIG5_STEPS), "--log-every", "25",
        "--eval-every", str(CONFIG5_EVAL_EVERY), "--eval-batches",
        str(CONFIG5_EVAL_BATCHES), "--dropout", "0.2", "--device", "cuda"])
    want = dict(lstm_tiled_fwd=(CONFIG5_STEPS + n_evals * per_eval) * L,
                lstm_tiled_bwd=CONFIG5_STEPS * L)
    print(f"  kernel launches {launches} (predicted {want}: "
          f"{CONFIG5_STEPS} steps x {L} layers, + {n_evals} evals x "
          f"{per_eval} batches x {L} layers forward)", flush=True)
    expect(launches, "main", **want)
    for r in recs:
        print(f"  {json.dumps(r)}", flush=True)
    logged = [r for r in recs if "loss" in r]
    final = recs[-1]
    if final.get("note") != "final" or not final.get("eval_ppl", 0) > 0:
        fail(f"the run did not end with a final eval record: {final}")
    if not all(r["loss"] == r["loss"] and r["loss"] < 1e9 for r in logged):
        fail("a logged loss is not finite")
    if not logged[-1]["loss"] < logged[0]["loss"]:
        fail(f"the loss did not fall: {logged[0]['loss']} -> "
             f"{logged[-1]['loss']}")
    sps = sorted(r["steps_per_sec"] for r in logged[1:])
    tps = sorted(r["tokens_per_sec"] for r in logged[1:])
    print(f"  loss at step {logged[0]['step']} {logged[0]['loss']:.6f}, at "
          f"step {logged[-1]['step']} {logged[-1]['loss']:.6f}; final "
          f"eval_loss {final['eval_loss']:.6f}, eval_ppl "
          f"{final['eval_ppl']:.4f}; steady state (median of the log windows "
          f"after the first) {sps[len(sps) // 2]:.2f} steps/s, "
          f"{tps[len(tps) // 2]:.1f} tokens/s", flush=True)

    # device idle share over 20 steps under torch.profiler, of the run the
    # CLI builds
    twenty = cli_steps(cli, CONFIG5_FLAGS + ["--dropout", "0.2", "--device",
                                             "cuda"])
    prof = device_profile(torch, twenty)
    if prof is None:
        print("  20 steps under torch.profiler: no device time recorded "
              "(idle share not measured)", flush=True)
    else:
        busy, wall, by_name, counts = prof
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(f"  20 config-5 steps under torch.profiler: device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall (idle share "
              f"{1 - busy / wall:.3f}); top: "
              + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top), flush=True)
        # where a step's time goes: the tiled kernels, the products outside
        # them (projections, head, dU, dW), everything else the device ran
        # (optimizer, elementwise, embedding, copies), and host time the
        # device work does not cover
        parts = {"tiled kernels": 0.0, "matmuls": 0.0, "other": 0.0}
        for k, v in by_name.items():
            if "lstm_tiled_" in k:
                parts["tiled kernels"] += v
            elif any(w in k.lower() for w in ("gemm", "cutlass", "xmma")):
                parts["matmuls"] += v
            else:
                parts["other"] += v
        parts["host, uncovered"] = wall - busy
        print("  a config-5 step, by part: " + "; ".join(
            f"{k} {v / 20:.3f} ms" for k, v in parts.items()), flush=True)
        per_launch = {}
        for kind in ("fwd", "bwd"):
            keys = [k for k in by_name if f"lstm_tiled_{kind}_kernel" in k]
            n = sum(counts[k] for k in keys)
            if n:
                per_launch[kind] = round(sum(by_name[k] for k in keys) / n, 4)
        print(f"  the tiled kernels' device ms a launch in these steps: "
              f"{per_launch}", flush=True)
    # the launches the main run made, its capture's warm-up included
    return {"fwd": launches["lstm_tiled_fwd"]
            + warmups["main"]["lstm_tiled_fwd"],
            "bwd": launches["lstm_tiled_bwd"]
            + warmups["main"]["lstm_tiled_bwd"]}


def rate_and_profile(torch, calls, n, m):
    """(steps/s by the host's clock over ``n`` calls ending in a
    synchronise, device busy ms a step, idle share) of a :func:`cli_calls`
    run; the last two over ``m`` calls under torch.profiler (None when it
    records no device time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls(n)
    torch.cuda.synchronize()
    sps = n * calls.k / (time.perf_counter() - t0)
    prof = device_profile(torch, lambda: calls(m), cpu=False)
    if prof is None:
        return sps, None, None
    busy, wall = prof[0], prof[1]
    return sps, busy / (m * calls.k), 1 - busy / wall


def host_launches(torch, calls, n):
    """The CUDA API calls the host makes over ``n`` calls of a
    :func:`cli_calls` run under torch.profiler: {name: count} of the graph
    launches, kernel launches and copies."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        calls(n)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if "Launch" in e.key or "Memcpy" in e.key or "Memset" in e.key}


def train_calls_phase(torch, cli, cl, cx, ct, device, all_turns=True):
    print("== phase 14: train with K steps a call (every call a CUDA "
          "graph on the card)", flush=True)
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_calls_")
    counters = all_counters(cl, cx, ct)

    def run(name, flags, graph):
        """One CLI run, captured or eager, with every count set to 0 just
        before it and a time limit: (records, launches, plain runs)."""
        for c in counters.values():
            c.reset()
        path = os.path.join(tmp, f"{name}.jsonl")
        out = {}

        def target():
            try:
                out["rc"] = cli.main(flags + ["--jsonl", path], graph=graph)
            except BaseException as e:  # noqa: BLE001 — reported below
                out["error"] = e

        t0 = time.perf_counter()
        th = threading.Thread(target=target, daemon=True)
        th.start()
        th.join(CALL_RUN_LIMIT_S)
        if th.is_alive():
            print(f"chip_smoke: FAIL: {name}: no end after "
                  f"{CALL_RUN_LIMIT_S} s (a replay hangs)", flush=True)
            os._exit(1)
        if "error" in out:
            fail(f"{name}: {type(out['error']).__name__}: {out['error']}")
        if out["rc"] != 0:
            fail(f"train run {name} exited {out['rc']}")
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        launches = {k: c.kernel for k, c in counters.items()}
        plain = sum(c.reference for c in counters.values())
        return recs, launches, plain, time.perf_counter() - t0

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    def compare(label, flags):
        """The run captured against the same run eager: the losses of every
        logged window, and the launches (the captured run's, less its
        warm-ups', equal the eager run's)."""
        e_recs, e_l, e_plain, e_s = run(label + " eager", flags, False)
        g_recs, g_l, g_plain, g_s = run(label + " captured", flags, True)
        el = [r["loss"] for r in e_recs if "loss" in r]
        gl = [r["loss"] for r in g_recs if "loss" in r]
        if not el or len(el) != len(gl):
            fail(f"{label}: {len(el)} eager and {len(gl)} captured losses")
        gap = max(abs(a - b) for a, b in zip(el, gl))
        caps = [r for r in g_recs if r.get("note") == "graph capture"]
        warm = warmup_launches(g_recs, counters)
        replayed = {k: g_l[k] - warm[k] for k in g_l}
        print(f"  {label}: {len(el)} windows, max |d| of the losses "
              f"{gap:.3e} (limit {CALLS_TOL}); eager {e_s:.1f} s, captured "
              f"{g_s:.1f} s; launches eager {nonzero(e_l)}, captured "
              f"{nonzero(g_l)} = warm-up {nonzero(warm)} + replays and "
              f"evals {nonzero(replayed)}", flush=True)
        for r in caps:
            print(f"    capture {r['route']} do_eval={r['do_eval']} feed "
                  f"{r['feed']}: {r['nodes']} nodes, capture "
                  f"{r['capture_ms']:.1f} ms, warm-up {r['warmup_ms']:.1f} "
                  f"ms, launches a replay {r['launches']}", flush=True)
        if not caps or any(r["mid_run"] for r in caps):
            fail(f"{label}: captures {caps} (none, or one mid-run)")
        if not gap <= CALLS_TOL:
            fail(f"{label}: captured losses differ from eager by {gap:.3e}")
        if replayed != e_l or e_plain or g_plain:
            fail(f"{label}: launches under replay {replayed} != eager {e_l} "
                 f"(plain runs {e_plain}, {g_plain})")
        return e_recs, g_recs

    t_phase = time.perf_counter()
    c1 = TRAIN_FLAGS + ["--num-steps", str(CALLS_STEPS), "--log-every", "1",
                        "--device", "cuda"]
    e1, _ = compare("config 1, K=1", c1)
    # the floor of those differences: a second eager run against the first
    again, _, _, _ = run("config 1, K=1 eager again", c1, False)
    gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(
        [r for r in e1 if "loss" in r], [r for r in again if "loss" in r]))
    print(f"  config 1, K=1, eager against eager: max |d| {gap:.3e} (the "
          "embedding gradient's atomic adds run in another order each "
          "time)", flush=True)
    compare("config 1, K=8 host-fed", c1 + ["--steps-per-call", "8"])
    compare("config 1, K=8 --prefetch 2", c1 + ["--steps-per-call", "8",
                                                "--prefetch", "2"])
    fused = compare("config 1, K=8 --device-data --fused-eval", c1 + [
        "--steps-per-call", "8", "--device-data", "--fused-eval",
        "--eval-every", "5", "--eval-batches", str(EVAL_BATCHES)])
    for label, recs in zip(("eager", "captured"), fused):
        ev = [r for r in recs if "eval_loss" in r]
        if len(ev) != 2 or ev[-1].get("note") != "final":
            fail(f"fused eval ({label}): eval records {ev}")
        gap = abs(ev[0]["eval_loss"] - ev[1]["eval_loss"])
        print(f"    {label}: fused eval_loss at step {ev[0]['step']} "
              f"{ev[0]['eval_loss']:.7f}, host eval {ev[1]['eval_loss']:.7f}"
              f", |d| {gap:.3e} (limit {FUSED_EVAL_TOL})", flush=True)
        if not gap <= FUSED_EVAL_TOL:
            fail(f"fused eval ({label}) differs from the host eval by {gap}")
    c5 = CONFIG5_FLAGS + ["--num-steps", "8", "--log-every", "1",
                          "--steps-per-call", "4", "--dropout", "0.2",
                          "--eval-batches", "1"]
    compare("config 5's shard, K=4, dropout 0.2", c5)
    compare("config 5's shard, K=4, dropout 0.2, --remat-chunk 32",
            c5 + ["--remat-chunk", "32"])
    c2 = CONFIG2_FLAGS + ["--num-steps", "8", "--log-every", "1",
                          "--steps-per-call", "4", "--device-data",
                          "--dropout", "0.2", "--eval-batches", "1"]
    compare("config 2, K=4 --device-data, dropout 0.2", c2)
    compare("config 2, K=4 --device-data, dropout 0.2, --remat-chunk 50",
            c2 + ["--remat-chunk", "50"])
    print(f"  [the CLI runs: {time.perf_counter() - t_phase:.1f} s]",
          flush=True)

    # steps/s, device ms a step and the idle share of the runs the CLI
    # builds, eager and captured, in turns (eager, captured, captured,
    # eager): each run is built and warmed up once (its captures, then a
    # replay) and measured twice
    on = ["--device", "cuda"]
    k8 = ["--steps-per-call", "8"]
    cases = (
        ("config 1", TRAIN_FLAGS + on, (300, 40),
         (("captured K=1", []),
          ("captured K=8 --device-data", k8 + ["--device-data"]),
          ("captured K=8 --prefetch 2", k8 + ["--prefetch", "2"]))),
        ("config 5's shard, dropout 0.2",
         CONFIG5_FLAGS + on + ["--dropout", "0.2"], (20, 10),
         (("captured K=1", []),)),
        ("config 2, dropout 0.2", CONFIG2_FLAGS + on + ["--dropout", "0.2"],
         (20, 10), (("captured K=1", []),)),
        ("config 2, dropout 0.2, --remat-chunk 50",
         CONFIG2_FLAGS + on + ["--dropout", "0.2", "--remat-chunk", "50"],
         (4, 1), (("captured K=1", []),)),
    )
    if not all_turns:
        # the whole smoke times config 1 alone (its host-launch checks are
        # holds); the other turns' readings are in PERF.md §5, and
        # --train-calls times them all
        cases = cases[:1]
    for label, flags, (n, m), variants in cases:
        runs = {"eager": cli_calls(cli, flags, graph=False)}
        for name, extra in variants:
            runs[name] = cli_calls(cli, flags + extra)
        for calls in runs.values():
            calls(2)  # the captures, then a replay
        if label == "config 1":
            # the host between replays: one graph launch a call, no kernel
            # launch (the feed's copies are memcpys)
            for name in list(runs)[1:]:
                seen = host_launches(torch, runs[name], 20)
                launched = sum(v for k, v in seen.items()
                               if "LaunchKernel" in k)
                api = {k: v for k, v in seen.items() if k.startswith("cu")}
                on_dev = {k: v for k, v in seen.items() if k not in api}
                print(f"  config 1 {name}, 20 calls under torch.profiler: "
                      f"host calls {api}; on the device {on_dev}",
                      flush=True)
                if seen.get("cudaGraphLaunch") != 20 or launched:
                    fail(f"config 1 {name}: {seen.get('cudaGraphLaunch')} "
                         f"graph launches for 20 calls, {launched} kernel "
                         "launches from the host")
        order = ["eager"] + list(runs)[1:] + list(runs)[:0:-1] + ["eager"]
        got = {}
        for name in order:
            calls = runs[name]
            got.setdefault(name, []).append(rate_and_profile(
                torch, calls, max(n // calls.k, 1), max(m // calls.k, 1)))
        del runs, calls  # and the graphs' memory
        gc.collect()
        torch.cuda.empty_cache()

        def fmt(r):
            sps, ms, idle = r
            dev = ("not recorded" if ms is None
                   else f"{ms:.4f} ms a step, idle {idle:.3f}")
            return f"{sps:.2f} steps/s ({dev})"

        print(f"  {label} in turns: " + "; ".join(
            f"{name} " + ", ".join(fmt(r) for r in rs)
            for name, rs in got.items()) + f"; {card} "
            f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
            flush=True)


def weights_of(cd, tgen, params, cfg):
    return cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                             cfg.tie_embeddings)


def reject_draft(torch, tlm, dcfg, wrong, device):
    """The all-reject draft: zero weights and one spiked head bias on token
    ``wrong`` (one the target does not emit), so every proposal is
    rejected."""
    params = tlm.init_lm(torch.Generator().manual_seed(0), dcfg)
    zero = {"embedding": torch.zeros_like(params["embedding"]),
            "layers": [type(l)(*(torch.zeros_like(t) for t in l))
                       for l in params["layers"]],
            "head": {k: torch.zeros_like(v)
                     for k, v in params["head"].items()}}
    zero["head"]["bias"][wrong] = 10.0
    return tlm.params_to(zero, device)


def spec_inputs(torch, cfg, dcfg, B, K, seed, device, accept):
    """Carries and latches of one spec window; with B >= 4 row 1 is dead on
    entry and rows 2 and 3 end their budget inside the window (1 and 2
    tokens left). The all-accept draft (the target itself) starts from the
    target's carries."""
    g = torch.Generator().manual_seed(seed)
    L, H, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    h = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    c = (torch.randn((L, B, H), generator=g) * 0.5).to(device)
    if accept:
        dh, dc = h.clone(), c.clone()
    else:
        shape = (dcfg.num_layers, B, dcfg.hidden_size)
        dh = (torch.randn(shape, generator=g) * 0.5).to(device)
        dc = (torch.randn(shape, generator=g) * 0.5).to(device)
    tok = torch.randint(0, V, (B,), generator=g, dtype=torch.int32).to(device)
    alive = torch.ones(B, dtype=torch.int32, device=device)
    rem = torch.full((B,), K + 4, dtype=torch.int32, device=device)
    eos = torch.full((B,), -1, dtype=torch.int32, device=device)
    if B >= 4:
        alive[1], rem[1] = 0, 0
        rem[2], rem[3] = 1, 2
    return [h, c, dh, dc, tok, alive, rem, eos]


def compare_spec(torch, cs, tw, dw, inputs, K, label):
    """Kernel vs plain version on the same inputs; returns the max abs
    difference of the four carry arrays and the tokens each row emitted."""
    got = cs.spec_window(tw, dw, *inputs, k_draft=K)
    ref = cs.spec_window_reference(tw, dw, *inputs, k_draft=K)
    torch.cuda.synchronize()
    names = ("h", "c", "draft h", "draft c", "tokens", "next", "alive",
             "remaining")
    for name, a, b in zip(names[4:], got[4:], ref[4:]):
        if not torch.equal(a, b):
            fail(f"{label}: kernel {name} differ from the plain version:\n"
                 f"kernel {a.tolist()}\nplain  {b.tolist()}")
    err = max(float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4]))
    if err > TOL:
        fail(f"{label}: carries differ by {err:.3e} > {TOL}")
    return err, (got[4] != cs.PAD_TOKEN).sum(dim=0)


def spec_bound(cfg, dcfg, B, K, live, emitted):
    """Least time for one spec window: the larger of bytes over HBM
    bandwidth (both models' weights read once, embedding rows as gathered,
    carries in and out, the row vectors) and float32 FLOPs over the card's
    peak, counted for this run's data: K draft steps with the head per row
    live at entry, then, per emitted token, a target step with the head and
    a draft step without."""

    def cell(m):  # weights and products of the L fused cells
        return sum(((m.embed if l == 0 else m.hidden_size) + m.hidden_size)
                   * 4 * m.hidden_size for l in range(m.num_layers))

    V = cfg.vocab_size
    weights = sum(cell(m) + 4 * m.hidden_size * m.num_layers
                  + m.hidden_size * V + V for m in (cfg, dcfg))
    emb_rows = (min(emitted, V) * cfg.embed
                + min(K * live + emitted, V) * dcfg.embed)
    carries = 4 * B * (cfg.num_layers * cfg.hidden_size
                       + dcfg.num_layers * dcfg.hidden_size)
    ints = 4 * B + (K + 1) * B + 3 * B
    nbytes = 4 * (weights + emb_rows + carries + ints)
    flops = 2 * (K * live * (cell(dcfg) + dcfg.hidden_size * V)
                 + emitted * (cell(cfg) + cfg.hidden_size * V + cell(dcfg)))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def spec_kernel_phase(torch, tlm, tgen, cd, cs, draft_config, device):
    print("== phase 11: spec-window kernel vs plain version", flush=True)
    max_err = 0.0
    timings = {}
    drafts = ("random", "reject", "accept")
    for name, spec, cases, timed in (
            ("config1", CONFIG1,
             [(B, K, d, False) for B in (1, 8, 16) for K in (1, 2, 4)
              for d in drafts]
             + [(8, K, d, True) for K in (2, 4) for d in drafts], (16, 4)),
            ("config3", CONFIG3, [(4, 4, d, False) for d in drafts], (4, 4)),
            ("mid-layers-on-chip", MID_LAYERS_ON_CHIP,
             [(4, 4, d, False) for d in drafts], None),
            ("many-rows", MANY_ROWS, [(6000, 2, "random", False)], None)):
        models = {}
        for i, (B, K, draft, tied) in enumerate(cases):
            if tied not in models:
                cfg = tlm.LMConfig(vocab_size=spec["vocab"],
                                   hidden_size=spec["hidden"],
                                   num_layers=spec["layers"],
                                   tie_embeddings=tied)
                params = tlm.params_to(tlm.init_lm(
                    torch.Generator().manual_seed(1), cfg), device)
                dcfg = draft_config(cfg)
                dparams = tlm.params_to(tlm.init_lm(
                    torch.Generator().manual_seed(2), dcfg), device)
                models[tied] = (cfg, weights_of(cd, tgen, params, cfg),
                                dcfg, weights_of(cd, tgen, dparams, dcfg))
            cfg, tw, dcfg, dw = models[tied]
            accept = draft == "accept"
            inputs = spec_inputs(torch, cfg, dcfg, B, K, 200 + i, device,
                                 accept)
            h, c, _, _, *rows = inputs
            # the target's own greedy tokens over the window
            own = cs.spec_window_reference(tw, tw, h, c, h, c, *rows,
                                           k_draft=K)[4]
            if accept:
                ddcfg, ddw = cfg, tw
            elif draft == "reject":
                seen = set(own[own >= 0].tolist())
                wrong = next(t for t in range(cfg.vocab_size)
                             if t not in seen)
                ddcfg = dcfg
                ddw = weights_of(cd, tgen, reject_draft(
                    torch, tlm, dcfg, wrong, device), dcfg)
            else:
                ddcfg, ddw = dcfg, dw
            # row 0's EOS id: the last token this window emits for it
            first = cs.spec_window_reference(tw, ddw, *inputs, k_draft=K)[4]
            inputs[7][0] = first[first[:, 0] >= 0, 0][-1]
            label = (f"{name} L={cfg.num_layers} H={cfg.hidden_size} "
                     f"V={cfg.vocab_size} tied={tied} draft={draft} "
                     f"(L={ddcfg.num_layers} H={ddcfg.hidden_size}) B={B} "
                     f"k_draft={K}")
            err, n_emit = compare_spec(torch, cs, tw, ddw, inputs, K, label)
            # every row but the dead one emits exactly 1 token against the
            # all-reject draft; the rows with no EOS and a budget past the
            # window emit all W against the all-accept draft
            live = [r for r in range(B) if B < 4 or r != 1]
            if draft == "reject" and not bool((n_emit[live] == 1).all()):
                fail(f"{label}: the all-reject draft's rows emitted "
                     f"{n_emit.tolist()} tokens, not 1 each")
            full = list(range(4, B))
            if accept and not bool((n_emit[full] == K + 1).all()):
                fail(f"{label}: the all-accept draft's rows emitted "
                     f"{n_emit.tolist()} tokens, not W={K + 1} each")
            max_err = max(max_err, err)
            plan = cd.card_plan(
                ((cfg.num_layers, cfg.hidden_size, cfg.embed),
                 (ddcfg.num_layers, ddcfg.hidden_size, ddcfg.embed)),
                cfg.vocab_size, B, K, device)
            if draft != "accept":  # the all-accept draft is the target
                check_plan(name, plan)
            print(f"  {label}: tokens identical, emitted per row "
                  f"{n_emit.tolist()}, max carry diff {err:.3e}; {plan}",
                  flush=True)
        # exact ties in the target's head, where the blocks or lanes split it
        cfg, tw, dcfg, dw = models[False]
        B, K = cases[-1][0], cases[-1][1]
        for pair in tie_cases(cd, cfg, B, None, device):
            ttw = tie_weights(torch, cd, tw, [pair], 50.0)
            inputs = spec_inputs(torch, cfg, dcfg, B, K, 98, device, False)
            err, n_emit = compare_spec(torch, cs, ttw, dw, inputs, K,
                                       f"{name} tied columns {pair}")
            toks = cs.spec_window(ttw, dw, *inputs, k_draft=K)[4]
            if not bool((toks == pair[0]).any()):
                fail(f"{name}: the tied columns {pair} never won the argmax")
            max_err = max(max_err, err)
            print(f"  {name} B={B} k_draft={K} with the target's head columns "
                  f"{pair} tied: tokens identical (the lower index wins), "
                  f"max carry diff {err:.3e}", flush=True)
        if timed is None:
            continue
        B, K = timed
        cfg, tw, dcfg, dw = models[False]
        inputs = spec_inputs(torch, cfg, dcfg, B, K, 7, device, False)
        inputs[5].fill_(1)  # every row live, none at its budget end
        inputs[6].fill_(K + 4)
        _, n_emit = compare_spec(torch, cs, tw, dw, inputs, K, name)
        iters = 200 if name == "config1" else 10

        def kernel():
            return cs.spec_window(tw, dw, *inputs, k_draft=K)

        def plain():
            return cs.spec_window_reference(tw, dw, *inputs, k_draft=K)

        h, c, _, _, tok, alive, rem, eos = inputs

        def window():  # the plain decode window of W steps: a reference
            return cd.decode_window(tw, h, c, tok, alive, rem, eos, None,
                                    window=K + 1, temperature=1.0,
                                    greedy=True)

        plain_ms, kernel_ms, (p1, k1, k2, p2) = in_turns(
            torch, plain, kernel, iters)
        window_ms = time_ms(torch, window, iters)
        device_ms = profiled_ms(torch, kernel, "spec_window", 20)
        emitted = int(n_emit.sum())
        bound_ms, bound_by = spec_bound(cfg, dcfg, B, K, B, emitted)
        plan = cd.card_plan(((cfg.num_layers, cfg.hidden_size, cfg.embed),
                             (dcfg.num_layers, dcfg.hidden_size, dcfg.embed)),
                            cfg.vocab_size, B, K, device)
        (t_lay, t_head), (d_lay, d_head) = plan.offchip_bytes
        propose = step_floor_ms(d_lay + d_head)
        verify = step_floor_ms(t_lay + t_head + d_lay)
        steps = int(n_emit.max())  # verify steps run: the longest row's
        floor = K * propose + steps * verify
        timings[name] = dict(B=B, K=K, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, device_ms=device_ms,
                             window_ms=window_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
        if name == "config1":  # every proposal accepted: W steps a row
            acc = spec_inputs(torch, cfg, cfg, B, K, 7, device, True)
            acc[5].fill_(1)
            acc[6].fill_(K + 4)
            _, acc_emit = compare_spec(torch, cs, tw, tw, acc, K, name)
            acc_ms = time_ms(torch, lambda: cs.spec_window(
                tw, tw, *acc, k_draft=K), iters)
            print(f"  {name} B={B} k_draft={K} all-accept draft (the target, "
                  f"{int(acc_emit.sum())} tokens emitted): kernel_ms "
                  f"{acc_ms:.4f}", flush=True)
        dev = "not recorded" if device_ms is None else f"{device_ms:.4f}"
        print(f"  {name} B={B} k_draft={K} (random draft, {emitted} tokens "
              f"emitted, per row {n_emit.tolist()}): kernel_ms "
              f"{kernel_ms:.4f} ({k1:.4f}, {k2:.4f}), device ms per launch "
              f"{dev}, plain_ms {plain_ms:.4f} ({p1:.4f}, {p2:.4f}), "
              f"bound_ms {bound_ms:.6f} ({bound_by}); per-step floor "
              f"propose {propose:.6f} ms, verify {verify:.6f} ms, "
              f"{floor:.6f} ms for this window ({K} + {steps} steps); the "
              f"plain decode window at K={K + 1}: kernel {window_ms:.4f} ms",
              flush=True)
    return max_err, timings


def spec_serve_phase(torch, tlm, tgen, cd, cs, cl, serve, draft_config,
                     device):
    print("== phase 12: speculative serving of config 1 over HTTP",
          flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    dcfg = draft_config(cfg)
    dparams_cpu = tlm.init_lm(torch.Generator().manual_seed(1), dcfg)
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, cfg.vocab_size, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params_cpu, [p], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    eos_at = next((i for i in range(8, n_new) if refs[5][i] not in refs[5][:i]),
                  None)
    if eos_at is None:
        fail(f"no token of {refs[5]} first appears at step 8 or later")
    eos = refs[5][eos_at]
    expect = [list(r) for r in refs]
    expect[5] = refs[5][:eos_at + 1]
    results = {}
    spec_launches = None
    for label, draft in (("plain", None), ("random draft", "random"),
                         ("all-accept draft", "accept")):
        engine = serve.ServeEngine(params_cpu, cfg, device=device,
                                   num_slots=32, rng_seed=0)
        kw = {}
        if draft is not None:
            if draft == "random":
                engine.attach_draft(dparams_cpu, dcfg)
            else:  # the target as its own draft
                engine.attach_draft(params_cpu, cfg)
            kw = dict(speculative=True, spec_ladder=(2, 4))
        server = serve.ServeServer(engine, max_active=16, **kw)
        server.warmup(prompt_lens=lens)
        torch.cuda.synchronize()
        httpd = serve.make_http_server(server, "127.0.0.1", 0)
        port = httpd.server_address[1]
        http_thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        http_thread.start()

        def burst():
            out = [None] * len(prompts)

            def run(i):
                body = {"prompt": prompts[i], "max_new_tokens": n_new,
                        "greedy": True}
                if i == 5:
                    body["eos_id"] = eos
                out[i] = post(port, body)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if any(t.is_alive() for t in threads):
                fail(f"{label}: a request did not finish")
            for i, r in enumerate(out):
                if r is None or r[0] != 200:
                    fail(f"{label}: request {i} failed: {r}")
                if r[1]["tokens"] != expect[i]:
                    fail(f"{label}: request {i}: served tokens "
                         f"{r[1]['tokens']} != plain generate on the CPU "
                         f"{expect[i]}")
            return out, time.perf_counter() - t0

        try:
            with server:
                before = server.stats()["batcher"]
                for counts in (cd.counts, cs.counts, cl.fwd_counts):
                    counts.reset()
                out, wall = burst()
                launches = {"spec_window": cs.counts.kernel,
                            "decode_window": cd.counts.kernel,
                            "lstm_fwd": cl.fwd_counts.kernel}
                plain_runs = cs.counts.reference + cd.counts.reference
                after = server.stats()["batcher"]
                prof = device_profile(torch, burst)
        finally:
            httpd.shutdown()
            httpd.server_close()
            http_thread.join(30)
        if plain_runs != 0:
            fail(f"{label}: {plain_runs} windows ran the plain version on "
                 "the card")
        if launches["lstm_fwd"] < 1:
            fail(f"{label}: the prefills launched the lstm_fwd kernel no time")
        spec_windows = (sum(after["spec_windows_dispatched"].values())
                        - sum(before["spec_windows_dispatched"].values()))
        accepted = (after["spec_accepted_tokens"]
                    - before["spec_accepted_tokens"])
        rows = after["spec_rows_verified"] - before["spec_rows_verified"]
        if draft is not None:
            if spec_windows < 1:
                fail(f"{label}: the burst dispatched no speculative window")
            if launches["spec_window"] != spec_windows:
                fail(f"{label}: {launches['spec_window']} spec kernel "
                     f"launches != {spec_windows} spec windows dispatched")
            if after["draft_prefill_failures"] != 0:
                fail(f"{label}: {after['draft_prefill_failures']} draft "
                     "prefills failed")
            if spec_launches is None:
                spec_launches = launches["spec_window"]
        elif launches["spec_window"] != 0:
            fail("the plain burst launched the spec kernel")
        tokens = sum(len(r[1]["tokens"]) for r in out)
        ttft = sorted(r[1]["ttft_ms"] for r in out)
        itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in out)
        results[label] = tokens / wall
        line = (f"  {label}: 6 requests, tokens identical to the plain "
                f"generate on the CPU; {tokens} tokens in {wall:.3f} s = "
                f"{tokens / wall:.1f} tokens/s; launches {launches}")
        if draft is not None:
            line += (f"; spec windows {spec_windows} (by K_draft "
                     f"{after['spec_windows_dispatched']}), "
                     f"mean accepted length "
                     f"{accepted / max(rows, 1):.3f} ({accepted} accepted "
                     f"over {rows} row-windows), draft prefills "
                     f"{after['draft_prefills_dispatched']} "
                     f"(failures {after['draft_prefill_failures']})")
        print(line, flush=True)
        print(f"  {label}: ttft_ms {ttft} (median {ttft[len(ttft) // 2]}); "
              f"max_itl_ms {itl}", flush=True)
        if prof is None:
            print(f"  {label} under torch.profiler: no device time recorded "
                  "(device idle share not measured)", flush=True)
        else:
            busy, pwall, by_name, _ = prof
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            print(f"  {label} burst under torch.profiler: device busy "
                  f"{busy:.3f} ms of {pwall:.3f} ms wall (idle share "
                  f"{1 - busy / pwall:.3f}); top: "
                  + "; ".join(f"{k[:40]} {v:.3f} ms" for k, v in top),
                  flush=True)
    print(f"  tokens/s: spec (random draft) / plain "
          f"{results['random draft'] / results['plain']:.3f}, spec "
          f"(all-accept draft) / plain "
          f"{results['all-accept draft'] / results['plain']:.3f}",
          flush=True)
    return spec_launches


def config3_burst(torch, tlm, tgen, cd, serve, device,
                  compute_dtype="float32"):
    """Phase 4's 6-request greedy burst (32 new tokens, request 5 with an
    eos_id) over HTTP at config 3's width (L=2, H=650, V=33,278, seeded
    weights), where the decode window sets the pace: tokens against the
    plain ``generate`` on the CPU, the window kernel's launches (its form of
    ``compute_dtype``), no plain window on the card; returns tokens/s,
    TTFT, the largest gap between tokens, the device's idle share and the
    launches."""
    import dataclasses

    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG3)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    counts = cd.counts_bf16 if compute_dtype == "bfloat16" else cd.counts
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, cfg.vocab_size, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params_cpu, [q], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(q):].tolist()
            for q in prompts]
    eos_at = next((i for i in range(8, n_new) if refs[5][i] not in refs[5][:i]),
                  None)
    if eos_at is None:
        fail(f"config 3: no token of {refs[5]} first appears at step 8 or "
             "later")
    expect = [list(r) for r in refs]
    expect[5] = refs[5][:eos_at + 1]
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=32,
                               rng_seed=0)
    server = serve.ServeServer(engine, max_active=16)
    server.warmup(prompt_lens=lens)
    torch.cuda.synchronize()
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()

    def burst():
        out = [None] * len(prompts)

        def run(i):
            body = {"prompt": prompts[i], "max_new_tokens": n_new,
                    "greedy": True}
            if i == 5:
                body["eos_id"] = refs[5][eos_at]
            out[i] = post(port, body)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        if any(t.is_alive() for t in threads):
            fail("config 3: a request did not finish")
        for i, r in enumerate(out):
            if r is None or r[0] != 200:
                fail(f"config 3: request {i} failed: {r}")
            if r[1]["tokens"] != expect[i]:
                fail(f"config 3: request {i}: served tokens {r[1]['tokens']} "
                     f"!= plain generate on the CPU {expect[i]}")
        return out, time.perf_counter() - t0

    try:
        with server:
            counts.reset()
            out, wall = burst()
            launches, plain = counts.kernel, counts.reference
            prof = device_profile(torch, burst)
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_thread.join(30)
    if launches < 1:
        fail("config 3: the burst launched the decode-window kernel no time")
    if plain != 0:
        fail(f"config 3: {plain} decode windows ran the plain version on the "
             "card")
    tokens = sum(len(r[1]["tokens"]) for r in out)
    ttft = sorted(r[1]["ttft_ms"] for r in out)
    itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in out)
    idle = None if prof is None else 1 - prof[0] / prof[1]
    return dict(tokens=tokens, wall=wall, tokens_per_s=tokens / wall,
                ttft_ms=ttft, max_itl_ms=itl, idle=idle, launches=launches)


def burst_line(r):
    idle = ("not measured" if r["idle"] is None
            else f"{r['idle']:.3f}")
    return (f"{r['tokens']} tokens in {r['wall']:.3f} s = "
            f"{r['tokens_per_s']:.1f} tokens/s; ttft_ms {r['ttft_ms']} "
            f"(median {r['ttft_ms'][len(r['ttft_ms']) // 2]}); max_itl_ms "
            f"{r['max_itl_ms']}; device idle share {idle}; window launches "
            f"{r['launches']}")


def config3_phase(torch, tlm, tgen, cd, serve, device):
    print("== phase 13: serve config 3's width over HTTP", flush=True)
    r = config3_burst(torch, tlm, tgen, cd, serve, device)
    print(f"  6 concurrent requests at L=2 H=650 V=33278: tokens identical "
          f"to the plain generate on the CPU; {burst_line(r)}", flush=True)
    return r


# ---------------------------------------------------------------------------
# bf16: the recurrence kernels' bfloat16 forms (phases 5 and 9) and the
# LM family's bf16 training through the CLI (phase 15)
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12     # H100 SXM bfloat16, dense, tensor cores
# the bfloat16 forms against their plain twins on the card: both round h
# (and dz) to bfloat16 before each product, from float32 sums taken in
# another order, so a sum that lands by a rounding boundary rounds to the
# neighbouring bfloat16 value in one and not the other, and the difference
# travels down the chain. The float32 values (ys, hT, cT, cs) are held to
# BF16_TOL, the gradients dh0 and dc0 to BF16_GRAD_SHARE of their max
# |reference|; a stored bfloat16 element (z, dz) to one bfloat16 ulp of the
# reference element, or BF16_TOL of the stream's max(1, max |reference|)
BF16_TOL = 1e-3
BF16_GRAD_SHARE = 3e-3
# phase 7's bf16 part holds the cell states (cs, cT) to BF16_TOL of
# max(1, max |c|): its chains run 256-400 dependent steps, most of them
# unmasked, where c (not bounded by 1, unlike h) carries every earlier
# rounding of h that fell the other way (measured on an H100: 1.018e-3
# and 1.024e-3 absolute at config 2 unmasked and at the LM's T=256, every
# h-valued output within 8.8e-4; PERF.md section 6)
BF16X_C_SCALED = ("cs", "cT")
# (name, shape, masked cases) of each pair's bfloat16 form: config 1's
# window (U and U^T in the lanes' registers), U's and U^T's slices in
# shared memory (H=256), config 3's width on the resident pair (U through
# L2), an awkward narrow shape; config 3 (B=32, T=70, H=650) and config 5's
# shard on the tiled pair, and an awkward tiled shape (U rows past the
# registers: the shared-memory remainder in bfloat16)
BF16_RESIDENT = (("config1", LSTM_CONFIG1), ("ut_smem", LSTM_UT_SMEM),
                 ("config3-resident", LSTM_CONFIG3),
                 ("awkward", dict(B=6, T=33, H=40)))
BF16_TILED = (("config3", LSTM_CONFIG3), ("config5", LSTM_CONFIG5),
              ("awkward", LSTM_TILED_AWKWARD))
# phase 15: the first losses on the card (the kernels' route: the streams
# rounded to bfloat16, as JAX's --use-pallas) against the CPU run of the
# same command (the plain loop: zx and h rounded only at the products, as
# JAX's default scan), both at --dropout 0. The two rounding schemes
# differ by the streams' roundings, not only by the order of sums, so the
# limit is relative to the loss: 2e-3 of it (the CPU tests measure the gap
# at small widths: tests/test_torch_bf16.py)
BF16_LOSS_RTOL = 2e-3
BF16_FIRST = 5
BF16_STEPS = 60
CONFIG1_BF16_FLAGS = ["train", "--dataset", "ptb_char", "--hidden-units",
                      "128", "--num-layers", "1", "--batch-size", "64",
                      "--seq-len", "64", "--learning-rate", "0.5",
                      "--stateful", "--compute-dtype", "bfloat16"]
CONFIG3_BF16_FLAGS = ["train", "--dataset", "wikitext2", "--hidden-units",
                      "650", "--num-layers", "2", "--batch-size", "32",
                      "--seq-len", "70", "--optimizer", "sgd",
                      "--learning-rate", "2.0", "--clip-norm", "0.25",
                      "--stateful", "--compute-dtype", "bfloat16",
                      "--logits-dtype", "bfloat16"]
CONFIG5_BF16_FLAGS = ["train", "--dataset", "wikitext103", "--hidden-units",
                      "1024", "--num-layers", "4", "--batch-size", "16",
                      "--seq-len", "128", "--optimizer", "adam",
                      "--learning-rate", "1e-3", "--clip-norm", "1.0",
                      "--stateful", "--compute-dtype", "bfloat16",
                      "--logits-dtype", "bfloat16"]
# the bf16 run, its dropout, its layers, its pair ("resident" or "tiled")
BF16_RUNS = {"config1": (CONFIG1_BF16_FLAGS, "0", 1, "resident"),
             "config3": (CONFIG3_BF16_FLAGS, "0.5", 2, "tiled"),
             "config5": (CONFIG5_BF16_FLAGS, "0.2", 4, "tiled"),
             "config5-remat32": (CONFIG5_BF16_FLAGS + ["--remat-chunk", "32"],
                                 "0.2", 4, "tiled")}


def ptxas_registers(kernels, name):
    """{entry function: its ptxas register line} from the build log of
    kernel ``name`` (``-Xptxas -v``), for each template instance."""
    log = kernels.library_path(name).with_name(
        kernels.library_path(name).name + ".log")
    out, entry = {}, None
    for line in (log.read_text().splitlines() if log.is_file() else []):
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and entry is not None:
            out[entry] = line.split("Used")[1].split(",")[0].strip()
            entry = None
    return out


def form_registers(kernels, name, bf16):
    """The registers of the bfloat16 (or the float32) instances of kernel
    ``name``."""
    regs = ptxas_registers(kernels, name)
    return sorted({v for k, v in regs.items()
                   if ("__nv_bfloat16" in k) == bf16})


def bf16_held(torch, name, got, ref, label, stream, bad, scaled=False):
    """max |got - ref| of a bfloat16 form's output against its plain twin,
    and a note to print beside it: for a gradient that max as a share of
    max |reference|, for a stored bfloat16 stream the share of its
    elements more than one ulp of the reference element apart; a miss of
    the limits above is appended to ``bad`` (the phase fails after
    printing every case). ``scaled``: a float32 value held to BF16_TOL of
    max(1, max |reference|), as a sum of products is (phase 7's cell
    states, BF16X_C_SCALED)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    err = float(d.max())
    if not stream:
        grad = name in ("dh0", "dc0")
        scale = float(ref.abs().max())
        tol = (BF16_GRAD_SHARE * scale if grad
               else BF16_TOL * max(1.0, scale) if scaled else BF16_TOL)
        if not err <= tol:
            bad.append(f"{label}: bf16 kernel {name} differs from its plain "
                       f"twin by {err:.3e} > {tol:.3e}")
        return err, (f"{err / scale:.2e} of max {scale:.3e}"
                     if grad or scaled else None)
    # one ulp of a bfloat16 value: 2^(exponent - 7), the smallest normal's
    # for zero
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(
        ref.abs().clamp_min(2.0 ** -126))[1] - 8)
    floor = BF16_TOL * max(1.0, float(ref.abs().max()))
    over = d > ulp
    n_bad = int((over & (d > floor)).sum())
    if n_bad:
        bad.append(f"{label}: bf16 kernel {name}: {n_bad} elements differ "
                   "from the plain twin by more than one bfloat16 ulp and "
                   f"{floor:.3e} (max {err:.3e})")
    return err, f"{100 * float(over.float().mean()):.3f}% past 1 ulp"


def lstm_bound_bf16(B, T, H, kind, masked=False):
    """:func:`lstm_bound` of a bfloat16 form: xproj, z, dz and U at 2 bytes,
    the rest at 4; the products at the bfloat16 tensor-core peak."""
    G = 4 * H
    if kind == "fwd":  # xproj, U in (bf16); h0, c0 in; ys, hT, cT, cs out;
        # z out (bf16)
        b16 = T * B * G + H * G + T * B * G
        f32 = 2 * B * H + T * B * H + 2 * B * H + T * B * H
    else:  # z, U in (bf16); dys, cs, c0, dhT, dcT in; dz out (bf16);
        # dh0, dc0 out
        b16 = T * B * G + G * H + T * B * G
        f32 = 2 * T * B * H + B * H + 2 * B * H + 2 * B * H
    nbytes = 2 * b16 + 4 * f32 + 4 * (T * B if masked else 0)
    flops = 2 * T * B * H * G
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def cudnn_bf16_ms(torch, B, T, H, device):
    """cuDNN's ``torch.nn.LSTM`` in bfloat16 on one layer at B, T, H (input
    width H, seeded weights): (forward ms, backward-alone ms). A yardstick
    the port never calls."""
    g = torch.Generator().manual_seed(7)
    lstm = torch.nn.LSTM(H, H).to(device=device, dtype=torch.bfloat16)
    lstm.flatten_parameters()
    x = torch.randn(T, B, H, generator=g).to(device, torch.bfloat16)
    x.requires_grad_()
    h0 = torch.zeros(1, B, H, device=device, dtype=torch.bfloat16)
    cots = [torch.randn(T, B, H, generator=g).to(device, torch.bfloat16)]
    params = [x, *lstm.parameters()]
    ys, _ = lstm(x, (h0, h0))

    def fwd():
        return lstm(x, (h0, h0))

    def bwd():
        return torch.autograd.grad([ys], params, cots, retain_graph=True)

    return time_ms(torch, fwd, 20), time_ms(torch, bwd, 20)


def bf16_kernel_phase(torch, cl, ct, device, pair):
    """The bfloat16 forms of the resident pair (``pair="resident"``, with
    phase 5) or the tiled pair (``"tiled"``, with phase 9) against their
    plain twins at the configs' shapes, their plans and registers, and
    their times at the shape of their training path (config 1; config 5's
    shard) beside the plain twin, cuDNN in bfloat16 and the bound."""
    from lstm_tensorspark_torch import kernels

    resident = pair == "resident"
    print(f"== phase {5 if resident else 9}, bf16: the {pair} pair's "
          "bfloat16 forms vs their plain twins", flush=True)
    fwd = cl.lstm_forward if resident else ct.lstm_tiled_forward
    bwd = cl.lstm_backward if resident else ct.lstm_tiled_backward
    names = ("lstm_fwd", "lstm_bwd") if resident else ("lstm_tiled_fwd",
                                                       "lstm_tiled_bwd")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    regs = {n: form_registers(kernels, n, bf16=True) for n in names}
    print(f"  ptxas registers of the bfloat16 instances: {regs}",
          flush=True)
    errs = {"fwd": 0.0, "bwd": 0.0}
    bad = []

    def bf16_inputs(B, T, H, masked, seed):
        (xproj, U, h0, c0, mask), cots = lstm_inputs(torch, B, T, H, masked,
                                                     seed, device)
        return [xproj.bfloat16(), U.bfloat16(), h0, c0, mask], cots

    for name, spec in (BF16_RESIDENT if resident else BF16_TILED):
        B, T, H = spec["B"], spec["T"], spec["H"]
        for masked in (False, True):
            label = f"bf16 {pair} {name} B={B} T={T} H={H} mask={masked}"
            inputs, (dys, dhT, dcT) = bf16_inputs(B, T, H, masked,
                                                  seed=7 * H + B + masked)
            got = fwd(*inputs, save_residuals=True)
            bare = fwd(*inputs)
            ref = cl.lstm_forward_reference(*inputs, save_residuals=True)
            torch.cuda.synchronize()
            if got[3].dtype != torch.bfloat16:
                fail(f"{label}: the bf16 form stored z as {got[3].dtype}")
            e = {}
            for n, a, r in zip(("ys", "hT", "cT", "z", "cs"), got, ref):
                e[n] = bf16_held(torch, n, a, r, label, n == "z", bad)
            for n, a, r in zip(("ys", "hT", "cT"), bare, got):
                if not torch.equal(a, r):
                    fail(f"{label}: the forward without residuals gives "
                         f"other {n} than with them")
            z, cs = ref[3], ref[4]
            c_prev = torch.cat([inputs[3][None], cs[:-1]])
            bgot = bwd(z, inputs[3], cs, dys, inputs[1], dhT, dcT, inputs[4])
            bref = cl.lstm_backward_reference(z, c_prev, dys, inputs[1], dhT,
                                              dcT, inputs[4])
            torch.cuda.synchronize()
            if bgot[0].dtype != torch.bfloat16:
                fail(f"{label}: the bf16 form stored dz as {bgot[0].dtype}")
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n] = bf16_held(torch, n, a, r, label, n == "dz", bad)
            errs["fwd"] = max(errs["fwd"], *(e[n][0] for n in
                                             ("ys", "hT", "cT", "z", "cs")))
            errs["bwd"] = max(errs["bwd"], *(e[n][0] for n in
                                             ("dz", "dh0", "dc0")))
            print(f"  {label}: max |d| " + ", ".join(
                f"{n} {v[0]:.2e}" + ("" if v[1] is None else f" ({v[1]})")
                for n, v in e.items()), flush=True)
        if resident:
            print(f"  {name} bf16 plans: fwd {cl.plan('fwd', B, H, sms, esize=2)}"
                  f"; bwd (launched) "
                  f"{cl.card_plan('bwd', B, H, device, esize=2)}", flush=True)
        else:
            for kind in ("fwd", "bwd"):
                p = ct.card_plan(kind, B, H, device, 2)
                print(f"  {name} bf16 tiled {kind} plan: {p.blocks} blocks "
                      f"in clusters of {p.cluster}, {p.units} units a block, "
                      f"{p.per_lane} {'rows' if kind == 'fwd' else 'columns'}"
                      f" of U a lane ({p.u_regs} in registers), "
                      f"{p.smem_bytes} bytes of shared memory a block",
                      flush=True)
    if bad:
        fail("; ".join(bad))

    # times at the training path's shape: forward with residuals, backward
    # from them, unmasked
    spec = LSTM_CONFIG1 if resident else LSTM_CONFIG5
    B, T, H = spec["B"], spec["T"], spec["H"]
    inputs, (dys, dhT, dcT) = bf16_inputs(B, T, H, False, seed=1)
    _, _, _, z, cs = fwd(*inputs, save_residuals=True)
    c_prev = torch.cat([inputs[3][None], cs[:-1]])
    fns = {
        "fwd": (lambda: fwd(*inputs, save_residuals=True),
                lambda: cl.lstm_forward_reference(*inputs,
                                                  save_residuals=True)),
        "bwd": (lambda: bwd(z, inputs[3], cs, dys, inputs[1], dhT, dcT),
                lambda: cl.lstm_backward_reference(z, c_prev, dys, inputs[1],
                                                   dhT, dcT)),
    }
    lib = dict(zip(("fwd", "bwd"), cudnn_bf16_ms(torch, B, T, H, device)))
    timings = {}
    for kind, (kernel, plain) in fns.items():
        plain_ms, kernel_ms, r = in_turns(torch, plain, kernel,
                                          10 if resident else 5)
        bound_ms, bound_by = lstm_bound_bf16(B, T, H, kind)
        stem = "lstm" if resident else "lstm_tiled"
        dev_ms = profiled_ms(torch, kernel, f"{stem}_{kind}_kernel", 20)
        timings[f"{stem}_{kind}_bf16"] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev_ms, library_ms=lib[kind],
            max_err=errs[kind], shape=(B, T, H))
        print(f"  {stem}_{kind} bf16 at B={B} T={T} H={H}: kernel_ms "
              f"{kernel_ms:.4f} ({r[1]:.4f}, {r[2]:.4f}; "
              f"{1e3 * kernel_ms / T:.2f} us a step), device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain_ms {plain_ms:.4f} ({r[0]:.4f}, {r[3]:.4f}), "
              f"library_ms (cuDNN bf16) {lib[kind]:.4f}, bound_ms "
              f"{bound_ms:.6f} ({bound_by}, {kernel_ms / bound_ms:.1f}x)",
              flush=True)
    return timings


BF16_REPLACES = {
    "lstm_fwd_bf16": "lstm_tensorspark_tpu/ops/pallas_lstm.py:528",
    "lstm_bwd_bf16": "lstm_tensorspark_tpu/ops/pallas_lstm.py:597",
    "lstm_tiled_fwd_bf16": "lstm_tensorspark_tpu/ops/pallas_lstm.py:670",
    "lstm_tiled_bwd_bf16": "lstm_tensorspark_tpu/ops/pallas_lstm.py:744"}


def bf16_row(name, t, launches):
    """The kernel report's row of a bfloat16 form."""
    stem, replaces = BF16X_ROWS.get(name, (name[:-len("_bf16")],
                                           BF16_REPLACES.get(name)))
    return {"name": name, "route": "cuda",
            "source": f"lstm_tensorspark_torch/csrc/{stem}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_err"], "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def step_parts(torch, calls, m):
    """Where a step's time goes over ``m`` calls of a :func:`cli_calls`
    run under torch.profiler (device events only): the recurrence kernels,
    the library's matrix products, the other device work, and the host
    time the device work does not cover, each in ms a step (None when the
    profiler records no device time)."""
    prof = device_profile(torch, lambda: calls(m), cpu=False)
    if prof is None:
        return None
    busy, wall, by_name, _ = prof
    parts = {"recurrence kernels": 0.0, "matmuls": 0.0, "other": 0.0}
    for k, v in by_name.items():
        if "lstm_" in k or "lstmx_" in k:
            parts["recurrence kernels"] += v
        elif any(w in k.lower() for w in ("gemm", "cutlass", "xmma",
                                          "nvjet", "sm90_")):
            parts["matmuls"] += v
        else:
            parts["other"] += v
    parts["host, uncovered"] = wall - busy
    steps = m * calls.k
    return {k: v / steps for k, v in parts.items()}


def bf16_cli_run(cli, counters, tmp, name, flags):
    """One CLI run of phases 15 and 16, every count set to 0 just before
    it: its records, the launches of its replays and eager calls (the
    capture warm-ups' taken out, :func:`warmup_launches`; the plain
    twins' under "plain") and the warm-ups' launches."""
    for c in counters.values():
        c.reset()
    path = os.path.join(tmp, f"{name}.jsonl")
    t0 = time.perf_counter()
    rc = cli.main(flags + ["--jsonl", path])
    if rc != 0:
        fail(f"bf16 train run {name} exited {rc}")
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    warm = warmup_launches(recs, counters)
    launches = {k: c.kernel - warm[k] for k, c in counters.items()}
    launches["plain"] = sum(c.reference for c in counters.values())
    print(f"  {name}: {time.perf_counter() - t0:.1f} s; capture warm-up "
          f"launches { {k: v for k, v in warm.items() if v} }", flush=True)
    return recs, launches, warm


def bf16_in_turns(torch, cli, cfg, flags, drop, card, n_rate):
    """Phases 15 and 16: steps/s (over ``n_rate`` calls), device ms a step
    and the idle share of the float32 and the bf16 run of one command in
    turns (f32, bf16, bf16, f32), then each run's device ms a step by
    part. A remat step's graph holds 100,000-200,000 nodes: its profiles
    take the longest to read, so they cover two calls (phase 14's rule is
    one; the profiler can miss a window's first launches) after 4."""
    f32_flags = [("float32" if a == "bfloat16" else a) for a in flags]
    runs = {}
    for dt, fl in (("f32", f32_flags), ("bf16", flags)):
        calls = cli_calls(cli, fl + ["--dropout", drop, "--device", "cuda"])
        calls(3)
        runs[dt] = calls
    n_rate, m = (4, 2) if "remat" in cfg else (n_rate, 10)
    got = {}
    for dt in ("f32", "bf16", "bf16", "f32"):
        got.setdefault(dt, []).append(
            rate_and_profile(torch, runs[dt], n_rate, m))
    print(f"  {cfg} in turns (f32, bf16, bf16, f32; {card}): " + "; ".join(
        f"{dt} " + ", ".join(
            f"{s:.2f} steps/s, device "
            + ("not measured" if d is None else f"{d:.4f} ms a step, "
               f"idle {i:.3f}") for s, d, i in got[dt])
        for dt in ("f32", "bf16")), flush=True)
    for dt in ("f32", "bf16"):
        parts = step_parts(torch, runs[dt], m)
        print(f"  {cfg} {dt} step by part (ms a step over {m} calls): "
              + ("not measured" if parts is None else "; ".join(
                  f"{k} {v:.4f}" for k, v in parts.items())), flush=True)
    del runs
    gc.collect()


def bf16_train_phase(torch, cli, cl, cx, ct, device, all_turns=True):
    """Phase 15: configs 1, 3 and 5's shard in bf16 through the CLI, as
    their scripts run them (captured, the default): the first losses
    against the CPU run, the bf16 forms' launches (the float32 forms and
    the plain twins at 0), and steps/s, device ms a step and the idle
    share beside the float32 run of the same command, in turns."""
    print("== phase 15: bf16 training of the LM family through the CLI",
          flush=True)
    from lstm_tensorspark_torch.ops import lstm_cell

    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    counters = all_counters(cl, cx, ct)
    main_launches = {k: 0 for k in BF16_REPLACES}

    run = functools.partial(bf16_cli_run, cli, counters, tmp)

    cpu_losses = {}
    for cfg, (flags, drop, L, pair) in BF16_RUNS.items():
        n = BF16_FIRST
        first = flags + ["--num-steps", str(n), "--log-every", "1",
                         "--dropout", "0", "--eval-batches", "1"]
        base = cfg.split("-")[0]
        if base not in cpu_losses:  # remat gives the plain loop's values
            recs, _, _ = run(f"{cfg} first{n} cpu",
                             first + ["--device", "cpu"])
            cpu_losses[base] = [r["loss"] for r in recs if "loss" in r]
        recs, launches, _ = run(f"{cfg} first{n} card",
                                first + ["--device", "cuda"])
        card_l = [r["loss"] for r in recs if "loss" in r]
        cpu_l = cpu_losses[base]
        if len(card_l) != n or len(cpu_l) != n:
            fail(f"{cfg}: logged {len(card_l)} / {len(cpu_l)} losses, not "
                 f"{n}")
        gap = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        print(f"  {cfg} bf16, first {n} losses: card "
              f"{[round(x, 6) for x in card_l]}; CPU "
              f"{[round(x, 6) for x in cpu_l]}; max relative |d| {gap:.2e}"
              f" (limit {BF16_LOSS_RTOL})", flush=True)
        if not gap <= BF16_LOSS_RTOL:
            fail(f"{cfg} bf16: card losses differ from the CPU run by "
                 f"{gap:.3e} of the loss > {BF16_LOSS_RTOL}")
        stem = "lstm" if pair == "resident" else "lstm_tiled"
        others = {k: v for k, v in launches.items()
                  if v and k not in (f"{stem}_fwd_bf16", f"{stem}_bwd_bf16")}
        if others or not launches[f"{stem}_fwd_bf16"]:
            fail(f"{cfg} bf16: launches {launches}: wanted the {pair} "
                 "pair's bf16 forms alone")
        # the main run: the script's dropout, BF16_STEPS steps
        recs, launches, warm = run(f"{cfg} main", flags + [
            "--num-steps", str(BF16_STEPS), "--log-every", "20",
            "--dropout", drop, "--device", "cuda"])
        logged = [r for r in recs if "loss" in r]
        if not all(r["loss"] == r["loss"] and r["loss"] < 1e9
                   for r in logged):
            fail(f"{cfg} bf16: a logged loss is not finite")
        fw, bw = launches[f"{stem}_fwd_bf16"], launches[f"{stem}_bwd_bf16"]
        remat = "--remat-chunk" in flags
        if fw < BF16_STEPS * L or (bw == 0) != remat:
            fail(f"{cfg} bf16 main: launches {launches} (fwd at least "
                 f"{BF16_STEPS * L}; bwd {'none' if remat else 'some'})")
        for k in main_launches:
            main_launches[k] += launches[k] + warm[k]
        print(f"  {cfg} bf16 main ({BF16_STEPS} steps, dropout {drop}): "
              f"loss {logged[0]['loss']:.4f} -> {logged[-1]['loss']:.4f}; "
              f"launches { {k: v for k, v in launches.items() if v} }",
              flush=True)

        if all_turns or "remat" not in cfg:
            # a remat run's turns (two captures of 100,000-node graphs)
            # are left to --bf16 train: PERF.md §5 has their readings
            bf16_in_turns(torch, cli, cfg, flags, drop, card,
                          {"config1": 300, "config3": 40}.get(cfg, 20))
    return main_launches


# ---------------------------------------------------------------------------
# bf16 of the residentx pair: phase 7's bfloat16 part and phase 16 (config
# 2 and the LM at T=256 in bf16 through the CLI)
# ---------------------------------------------------------------------------

# the residentx pair's bfloat16 forms against their plain twins (phase 5's
# limits above): config 2 one and two directions masked (8-row and 4-row
# chains, U in registers; U^T in shared memory), unmasked, the LM's T=256
# (U and U^T in registers), an awkward shape and the 8-row chain at an
# awkward width, and the forward's other builds (U in shared memory, through
# L2, one block a cluster)
BF16X_CASES = (("config2", 1, "imdb"), ("config2", 2, "imdb"),
               ("config2", 2, None), ("lm256", 1, None),
               ("awkward", 2, "awkward"), ("awkward8", 2, "awkward8"),
               ("smem", 2, None), ("l2", 1, None), ("tiny", 1, [5, 1, 3]))
# each row of the report: its source and the TPU kernel it replaces
BF16X_ROWS = {
    "lstmx_fwd_bf16": ("lstmx_fwd",
                       "lstm_tensorspark_tpu/ops/pallas_lstm.py:383"),
    "lstmx_bwd_bf16": ("lstmx_bwd",
                       "lstm_tensorspark_tpu/ops/pallas_lstm.py:444"),
    "bilstm_fwd_bf16": ("lstmx_fwd",
                        "lstm_tensorspark_tpu/ops/pallas_bilstm.py:108"),
    "bilstm_bwd_bf16": ("lstmx_bwd",
                        "lstm_tensorspark_tpu/ops/pallas_bilstm.py:178")}
# phase 16: configs/imdb_bilstm.sh's model and optimizer (config 2: B=32,
# T=400, E=H=256, Adam 1e-3, clip 1.0, dropout 0.2, bf16 compute), the same
# without --remat-chunk, and config 1's LM at --seq-len 256 in bf16
CONFIG2_BF16_FLAGS = [a if a != "float32" else "bfloat16"
                      for a in CONFIG2_FLAGS]
LM256_BF16_FLAGS = CONFIG1_BF16_FLAGS[:CONFIG1_BF16_FLAGS.index(
    "--seq-len") + 1] + ["256"] + CONFIG1_BF16_FLAGS[
    CONFIG1_BF16_FLAGS.index("--seq-len") + 2:]
BF16X_STEPS = 30
# run: (flags, dropout, the forward's counter and its launches a step and
# eval batch, the backward's counter or None, the report's rows whose
# main-path launches it gives)
BF16X_RUNS = {
    "config2-remat50": (CONFIG2_BF16_FLAGS + ["--remat-chunk", "50"], "0.2",
                        "lstmx_fwd_bf16", 2, None, ("lstmx_fwd_bf16",)),
    "config2": (CONFIG2_BF16_FLAGS, "0.2", "bilstm_fwd_bf16", 1,
                "bilstm_bwd_bf16", ("bilstm_fwd_bf16", "bilstm_bwd_bf16")),
    "lm256": (LM256_BF16_FLAGS, "0", "lstmx_fwd_bf16", 1, "lstmx_bwd_bf16",
              ("lstmx_bwd_bf16",))}


def bf16x_inputs(torch, B, T, D, H, ndir, lengths, seed, device):
    """:func:`lstmx_inputs` in the bfloat16 form: xs, W and U bfloat16."""
    (xs, W, b, U, h0, c0, mask), cots = lstmx_inputs(
        torch, B, T, D, H, ndir, lengths, seed, device)
    return [xs.bfloat16(), W.bfloat16(), b, U.bfloat16(), h0, c0, mask], cots


def bf16_residentx_phase(torch, cx, device):
    """Phase 7's bfloat16 part: the residentx pair's bfloat16 forms (one
    and two directions) against their plain twins at BF16X_CASES, their
    plans and registers, and each role timed at its main-path shape (as
    phase 7) beside the plain twin, cuDNN in bfloat16 and the bound."""
    from lstm_tensorspark_torch import kernels

    print("== phase 7, bf16: the residentx pair's bfloat16 forms vs their "
          "plain twins", flush=True)
    regs = {n: form_registers(kernels, n, bf16=True)
            for n in ("lstmx_fwd", "lstmx_bwd")}
    print(f"  ptxas registers of the bfloat16 instances: {regs}", flush=True)
    lens2 = imdb_lengths(CONFIG2["B"], CONFIG2["T"])
    errs = {(k, nd): 0.0 for k in ("fwd", "bwd") for nd in (1, 2)}
    bad = []
    for i, (name, ndir, lens) in enumerate(BF16X_CASES):
        B, T, D, H = (LSTMX_SHAPES[name][k] for k in ("B", "T", "D", "H"))
        lengths = lstmx_lengths(lens, lens2)
        label = (f"bf16 {name} B={B} T={T} D={D} H={H} ndir={ndir} "
                 f"mask={lengths is not None}")
        inputs, (dys, dhT, dcT) = bf16x_inputs(torch, B, T, D, H, ndir,
                                               lengths, 40 + i, device)
        xs, W, b, U, h0, c0, mask = inputs
        got = cx.lstmx_forward(*inputs, save_c=True)
        bare = cx.lstmx_forward(*inputs)
        ref = cx.lstmx_forward_reference(*inputs, save_c=True)
        torch.cuda.synchronize()
        e = {}
        for n, a, r in zip(("ys", "hT", "cT", "cs"), got, ref):
            e[n] = bf16_held(torch, n, a, r, label, False, bad,
                             scaled=n in BF16X_C_SCALED)
        for n, a, r in zip(("ys", "hT", "cT"), bare, got):
            if not torch.equal(a, r):
                fail(f"{label}: the forward without cs gives other {n} than "
                     "with it")
        # the backward from the twin's ys and cs, then from the kernel's own
        for fed, (ys, cs) in (("", (ref[0], ref[3])),
                              (" (own)", (got[0], got[3]))):
            bgot = cx.lstmx_backward(xs, ys, h0, cs, c0, dys, W, b, U, dhT,
                                     dcT, mask)
            bref = cx.lstmx_backward_reference(xs, ys, h0, cs, c0, dys, W, b,
                                               U, dhT, dcT, mask)
            torch.cuda.synchronize()
            if bgot[0].dtype != torch.bfloat16:
                fail(f"{label}: the bf16 form stored dz as {bgot[0].dtype}")
            for n, a, r in zip(("dz", "dh0", "dc0"), bgot, bref):
                e[n + fed] = bf16_held(torch, n, a, r, label + fed,
                                       n == "dz", bad)
        errs["fwd", ndir] = max(errs["fwd", ndir], *(
            e[n][0] for n in ("ys", "hT", "cT", "cs")))
        errs["bwd", ndir] = max(errs["bwd", ndir], *(
            v[0] for n, v in e.items() if n.split()[0] in ("dz", "dh0",
                                                           "dc0")))
        print(f"  {label}: max |d| " + ", ".join(
            f"{n} {v[0]:.2e}" + ("" if v[1] is None else f" ({v[1]})")
            for n, v in e.items()), flush=True)
        print(f"    plan {cx.card_plan(B, H, D, ndir, device, 2)}",
              flush=True)
    if bad:
        fail("; ".join(bad))

    timings, lib = {}, {}
    for role, (name, nd, kind, masked, save_c) in LSTMX_ROLES.items():
        B, T, D, H = (LSTMX_SHAPES[name][k] for k in ("B", "T", "D", "H"))
        if (name, nd) not in lib:
            lib[name, nd] = cudnn_bi_yardstick(torch, B, T, D, H, nd, device,
                                               torch.bfloat16)
        inputs, (dys, dhT, dcT) = bf16x_inputs(
            torch, B, T, D, H, nd, lens2 if masked else None, 7, device)
        xs, W, b, U, h0, c0, mask = inputs
        ys, _, _, cs = cx.lstmx_forward(*inputs, save_c=True)
        bargs = (xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask)
        if kind == "fwd":
            def kernel():
                return cx.lstmx_forward(*inputs, save_c=save_c)

            def plain():
                return cx.lstmx_forward_reference(*inputs, save_c=save_c)
        else:
            def kernel():
                return cx.lstmx_backward(*bargs)

            def plain():
                return cx.lstmx_backward_reference(*bargs)
        # in turns as the float32 roles of phase 7: 2 plain calls, 10
        # kernel calls a reading
        p1 = time_ms(torch, plain, 2)
        k1 = time_ms(torch, kernel, 10)
        k2 = time_ms(torch, kernel, 10)
        p2 = time_ms(torch, plain, 2)
        plain_ms, kernel_ms, r = (p1 + p2) / 2, (k1 + k2) / 2, (p1, k1, k2, p2)
        bound_ms, bound_by = lstmx_bound(B, T, D, H, nd, kind, masked,
                                         save_c, esize=2)
        prof = device_profile(torch, lambda: [kernel() for _ in range(10)])
        dev_ms = side_ms = None
        if prof is not None:
            for which in ("chain", "side"):
                pat = (f"lstmx_{kind}_kernel" if which == "chain"
                       else LSTMX_SIDE[kind])
                keys = [k for k in prof[2] if pat in k]
                n = sum(prof[3][k] for k in keys)
                if n and which == "chain":
                    dev_ms = sum(prof[2][k] for k in keys) / n
                elif n:
                    side_ms = sum(prof[2][k] for k in keys) / n
        key = f"{role}_bf16"
        timings[key] = dict(
            kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev_ms,
            library_ms=lib[name, nd][0 if kind == "fwd" else 1],
            max_err=errs[kind, nd], shape=(B, T, D, H, nd))
        side = "projection" if kind == "fwd" else "z rebuild"
        print(f"  {key} {name} B={B} T={T} D={D} H={H} (mask={masked}, "
              f"cs={save_c if kind == 'fwd' else 'in'}): kernel_ms "
              f"{kernel_ms:.4f} ({r[1]:.4f}, {r[2]:.4f}; "
              f"{1e3 * kernel_ms / T:.2f} us a step), device_ms "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
              f"(the chain; its {side} "
              + ("not measured" if side_ms is None else f"{side_ms:.4f}")
              + f"), plain_ms {plain_ms:.4f} ({r[0]:.4f}, {r[3]:.4f}), "
              f"library_ms (cuDNN bf16"
              f"{' bidirectional' if nd == 2 else ''}) "
              f"{timings[key]['library_ms']:.4f}, bound_ms {bound_ms:.6f} "
              f"({bound_by}, {kernel_ms / bound_ms:.1f}x); {card_line()}",
              flush=True)
    return timings


def bf16x_train_phase(torch, cli, cl, cx, ct, device, host,
                      all_turns=True):
    """Phase 16: config 2 as configs/imdb_bilstm.sh runs it (bf16,
    --remat-chunk 50: the residentx forward's bf16 form a direction, then
    the plain recompute), the same without remat (the stacked pair's bf16
    forms) and the LM at --seq-len 256 in bf16 (the one-direction pair),
    through the CLI, captured: the first losses at --dropout 0 against the
    CPU run of the same command, exact bf16 launch counts with the capture
    warm-ups taken out (every other counter and the plain twins at 0), a
    main run at the script's dropout, and steps/s, device ms a step, the
    idle share and the device ms a step by part beside the float32 run of
    the same command, in turns (f32, bf16, bf16, f32). Returns each row's
    launches on the main path (the main runs', warm-ups included)."""
    print("== phase 16: bf16 training of config 2 and the LM at T=256 "
          "through the CLI", flush=True)
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16x_")
    counters = all_counters(cl, cx, ct)

    run = functools.partial(bf16_cli_run, cli, counters, tmp)

    def expect(got, name, fwd, per, bwd, n):
        # n steps and the final eval's one batch
        want = {k: 0 for k in counters}
        want["plain"] = 0
        want[fwd] = per * (n + 1)
        if bwd is not None:
            want[bwd] = n
        if got != want:
            fail(f"{name}: launch counts {got} != predicted {want}")

    main_path = {k: 0 for k in BF16X_ROWS}
    cpu_losses = {}
    for cfg, (flags, drop, fwd, per, bwd, rows) in BF16X_RUNS.items():
        n = BF16_FIRST
        first = first_flags(flags, n)
        base = cfg.split("-")[0]
        if base == "config2":  # a host run beside the card (HostRuns); the
            # plain loop's values do not depend on remat
            cpu_losses[base] = host.losses(*host_references()[1])
        elif base not in cpu_losses:
            recs, _, _ = run(f"{cfg} first{n} cpu",
                             first + ["--device", "cpu"])
            cpu_losses[base] = [r["loss"] for r in recs if "loss" in r]
        recs, launches, _ = run(f"{cfg} first{n} card",
                                first + ["--device", "cuda"])
        expect(launches, f"{cfg} first{n} card", fwd, per, bwd, n)
        card_l = [r["loss"] for r in recs if "loss" in r]
        cpu_l = cpu_losses[base]
        if len(card_l) != n or len(cpu_l) != n:
            fail(f"{cfg}: logged {len(card_l)} / {len(cpu_l)} losses, not "
                 f"{n}")
        gap = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        print(f"  {cfg} bf16, first {n} losses: card "
              f"{[round(x, 6) for x in card_l]}; CPU "
              f"{[round(x, 6) for x in cpu_l]}; max relative |d| {gap:.2e}"
              f" (limit {BF16_LOSS_RTOL}); launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        if not gap <= BF16_LOSS_RTOL:
            fail(f"{cfg} bf16: card losses differ from the CPU run by "
                 f"{gap:.3e} of the loss > {BF16_LOSS_RTOL}")
        # the main run: the script's dropout, BF16X_STEPS steps
        recs, launches, warm = run(f"{cfg} main", flags + [
            "--num-steps", str(BF16X_STEPS), "--log-every", "10",
            "--dropout", drop, "--eval-batches", "1", "--device", "cuda"])
        expect(launches, f"{cfg} main", fwd, per, bwd, BF16X_STEPS)
        logged = [r for r in recs if "loss" in r]
        if not all(r["loss"] == r["loss"] and r["loss"] < 1e9
                   for r in logged):
            fail(f"{cfg} bf16: a logged loss is not finite")
        for k in rows:
            main_path[k] = launches[k] + warm[k]
        print(f"  {cfg} bf16 main ({BF16X_STEPS} steps, dropout {drop}): "
              f"loss {logged[0]['loss']:.4f} -> {logged[-1]['loss']:.4f}; "
              f"launches { {k: v for k, v in launches.items() if v} } "
              f"(+ warm-up { {k: v for k, v in warm.items() if v} })",
              flush=True)

        if all_turns or "remat" not in cfg:  # as in phase 15
            bf16_in_turns(torch, cli, cfg, flags, drop, card, 100)
    return main_path


# ---------------------------------------------------------------------------
# phase 17: train with checkpoints, resume, serve that checkpoint in bf16
# ---------------------------------------------------------------------------

# (a) the windows' bfloat16 forms (W and U bfloat16, x and h rounded at the
# products) and the recurrence forwards' plain-rounding form (xproj float32,
# U bfloat16: the serve prefill's) against their plain twins, held as phase
# 5 holds the bf16 forms: tokens identical, float32 values (h, c, ys) to
# BF16_TOL (both round h to bfloat16 from float32 sums taken in another
# order, so a sum by a rounding boundary can round the other way). Shapes:
# config 1 (decode B=16, K=8; spec k_draft=4) and config 3's width (B=4,
# K=4; k_draft=4); the prefill forms at a serve prefill batch of config 1
# (B=8, T=16, masked: the resident forward) and of config 3's width (B=4,
# T=40, masked: the tiled forward)
BF16_WINDOWS = (("config1", CONFIG1, 16, 8, 4), ("config3", CONFIG3, 4, 4, 4))
BF16U_PREFILL = (("lstm_fwd_bf16u", dict(B=8, T=16, H=128)),
                 ("lstm_tiled_fwd_bf16u", dict(B=4, T=40, H=650)))


def bf16_window_weights(torch, cd, tgen, params, cfg, ldtype=None):
    """Decode weights of ``cfg``'s model fused in bfloat16 (the serve
    engine's under ``--compute-dtype bfloat16``), logits in ``ldtype``."""
    import dataclasses

    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    return cd.decode_weights(params, tgen.fuse_layers(params, cfg),
                             cfg.tie_embeddings, ldtype or torch.float32)


def window_bound_bf16(cfg, B, K, row_steps, draft=None, live=0, emitted=0):
    """Least time of a bfloat16 window: W and U at 2 bytes an element (the
    rest as :func:`bound` and :func:`spec_bound` count it) over HBM
    bandwidth, against the layers' products over the bf16 tensor-core peak
    plus the float32 head's over the float32 peak. A decode window runs
    ``row_steps`` row steps; with a ``draft``, a spec window whose rows
    ran K draft steps each (``live`` rows) and ``emitted`` target and
    draft steps."""
    def cell(m):
        return sum(((m.embed if l == 0 else m.hidden_size) + m.hidden_size)
                   * 4 * m.hidden_size for l in range(m.num_layers))

    V = cfg.vocab_size
    models = (cfg,) if draft is None else (cfg, draft)
    nbytes = sum(2 * cell(m) + 4 * (4 * m.hidden_size * m.num_layers
                                    + m.hidden_size * V + V)
                 + 4 * 4 * m.num_layers * B * m.hidden_size for m in models)
    if draft is None:
        nbytes += 4 * min(row_steps, V) * cfg.embed + 4 * B * (K + 7)
        mm = 2 * row_steps * cell(cfg)
        head = 2 * row_steps * cfg.hidden_size * V
    else:
        nbytes += 4 * (min(emitted, V) * cfg.embed
                       + min(K * live + emitted, V) * draft.embed
                       + B * (K + 8))
        mm = 2 * (K * live * cell(draft) + emitted * (cell(cfg) + cell(draft)))
        head = 2 * V * (K * live * draft.hidden_size
                        + emitted * cfg.hidden_size)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = mm / PEAK_BF16_FLOPS + head / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def held_bf16(got, ref, label, names, n_exact):
    """Fail unless the first ``n_exact`` outputs past the float ones are
    identical and every float output is within BF16_TOL; returns the max
    float difference."""
    import torch

    torch.cuda.synchronize()
    nf = len(names) - n_exact
    for name, a, b in zip(names[nf:], got[nf:], ref[nf:]):
        if not torch.equal(a, b):
            fail(f"{label}: kernel {name} differ from the plain twin:\n"
                 f"kernel {a.tolist()}\nplain  {b.tolist()}")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got[:nf], ref[:nf]))
    if err > BF16_TOL:
        fail(f"{label}: {'/'.join(names[:nf])} differ by {err:.3e} > "
             f"{BF16_TOL}")
    return err


def in_turns_ms(torch, f32_fn, bf16_fn, iters):
    """CUDA-event ms of two forms in turns (f32, bf16, bf16, f32)."""
    a1 = time_ms(torch, f32_fn, iters)
    b1 = time_ms(torch, bf16_fn, iters)
    b2 = time_ms(torch, bf16_fn, iters)
    a2 = time_ms(torch, f32_fn, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2, (a1, b1, b2, a2)


def bf16_windows_phase(torch, tlm, tgen, cd, cs, cl, ct, draft_config,
                       device):
    print("== phase 17a: the windows' bf16 forms and the prefill's "
          "plain-rounding forms vs their plain twins", flush=True)
    out = {"decode_window_bf16": dict(max_err=0.0),
           "spec_window_bf16": dict(max_err=0.0)}
    dnames = ("h", "c", "tokens", "next", "alive", "remaining")
    snames = ("h", "c", "draft h", "draft c", "tokens", "next", "alive",
              "remaining")
    for name, spec, B, K, kd in BF16_WINDOWS:
        cfg, _, params = make_model(torch, tlm, 1, device=device, **spec)
        w32 = weights_of(cd, tgen, params, cfg)
        wb = bf16_window_weights(torch, cd, tgen, params, cfg)
        shape = ((cfg.num_layers, cfg.hidden_size, cfg.embed),)
        plan = cd.card_plan(shape, cfg.vocab_size, B, None, device, 2)
        cases = [(True, None), (False, None)]
        if name == "config1":
            cases.append((True, torch.bfloat16))
        for i, (greedy, ld) in enumerate(cases):
            w = wb if ld is None else wb._replace(ldtype=ld)
            inputs = window_inputs(torch, cd, w, cfg, B, K, greedy,
                                   seed=300 + i, device=device,
                                   edge_rows=True)
            args = dict(window=K, temperature=0.7, greedy=greedy)
            err = held_bf16(cd.decode_window(w, *inputs, **args),
                            cd.decode_window_reference(w, *inputs, **args),
                            f"decode bf16 {name} greedy={greedy} "
                            f"ldtype={ld or torch.float32}", dnames, 4)
            out["decode_window_bf16"]["max_err"] = max(
                out["decode_window_bf16"]["max_err"], err)
            print(f"  decode bf16 {name} B={B} K={K} greedy={greedy} "
                  f"logits {ld or torch.float32}: tokens identical, max "
                  f"|dh|,|dc| = {err:.3e}; {plan}", flush=True)
        # the spec window: the draft_config draft (bf16, as the target)
        dcfg = draft_config(cfg)
        dparams = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(2),
                                            dcfg), device)
        dw32 = weights_of(cd, tgen, dparams, dcfg)
        dwb = bf16_window_weights(torch, cd, tgen, dparams, dcfg)
        splan = cd.card_plan(shape + ((dcfg.num_layers, dcfg.hidden_size,
                                       dcfg.embed),), cfg.vocab_size, B, kd,
                             device, 2)
        for accept in (False, True):
            dw_ = wb if accept else dwb
            inputs = spec_inputs(torch, cfg, cfg if accept else dcfg, B, kd,
                                 310 + accept, device, accept)
            err = held_bf16(cs.spec_window(wb, dw_, *inputs, k_draft=kd),
                            cs.spec_window_reference(wb, dw_, *inputs,
                                                     k_draft=kd),
                            f"spec bf16 {name} accept={accept}", snames, 4)
            out["spec_window_bf16"]["max_err"] = max(
                out["spec_window_bf16"]["max_err"], err)
            print(f"  spec bf16 {name} B={B} k_draft={kd} "
                  f"{'all-accept' if accept else 'random'} draft: tokens "
                  f"identical, max carry diff {err:.3e}; {splan}",
                  flush=True)
        # timing: every row live, greedy; each bf16 form beside its f32 form
        # in turns, its plain twin, its device ms and its bound
        iters = 100 if name == "config1" else 20
        inputs = window_inputs(torch, cd, wb, cfg, B, K, True, seed=7,
                               device=device, edge_rows=False)
        args = dict(window=K, temperature=1.0, greedy=True)
        row_steps = int((cd.decode_window(wb, *inputs, **args)[2]
                         != cd.PAD_TOKEN).sum())
        f32_ms, bf_ms, turns = in_turns_ms(
            torch, lambda: cd.decode_window(w32, *inputs, **args),
            lambda: cd.decode_window(wb, *inputs, **args), iters)
        plain_ms = time_ms(
            torch, lambda: cd.decode_window_reference(wb, *inputs, **args),
            max(5, iters // 10))
        dev_ms = profiled_ms(torch, lambda: cd.decode_window(wb, *inputs,
                                                             **args),
                             "decode_window", 20)
        b_ms, b_by = window_bound_bf16(cfg, B, K, row_steps)
        out["decode_window_bf16"][name] = dict(
            kernel_ms=bf_ms, f32_ms=f32_ms, plain_ms=plain_ms,
            device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  decode {name} B={B} K={K}: bf16 kernel_ms {bf_ms:.4f}, "
              f"f32 kernel_ms {f32_ms:.4f} (turns f32/bf16/bf16/f32 "
              f"{', '.join(f'{t:.4f}' for t in turns)}), bf16 device ms "
              f"{'not recorded' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain twin {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by}); off-chip weight bytes a step "
              f"{sum(plan.offchip_bytes[0])}", flush=True)
        inputs = spec_inputs(torch, cfg, dcfg, B, kd, 7, device, False)
        inputs[5].fill_(1)
        inputs[6].fill_(kd + 4)
        toks = cs.spec_window(wb, dwb, *inputs, k_draft=kd)[4]
        emitted = int((toks != cs.PAD_TOKEN).sum())
        f32_ms, bf_ms, turns = in_turns_ms(
            torch, lambda: cs.spec_window(w32, dw32, *inputs, k_draft=kd),
            lambda: cs.spec_window(wb, dwb, *inputs, k_draft=kd), iters)
        plain_ms = time_ms(
            torch, lambda: cs.spec_window_reference(wb, dwb, *inputs,
                                                    k_draft=kd),
            max(5, iters // 10))
        dev_ms = profiled_ms(torch, lambda: cs.spec_window(wb, dwb, *inputs,
                                                           k_draft=kd),
                             "spec_window", 20)
        b_ms, b_by = window_bound_bf16(cfg, B, kd, 0, draft=dcfg, live=B,
                                       emitted=emitted)
        out["spec_window_bf16"][name] = dict(
            kernel_ms=bf_ms, f32_ms=f32_ms, plain_ms=plain_ms,
            device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"  spec {name} B={B} k_draft={kd} ({emitted} tokens emitted):"
              f" bf16 kernel_ms {bf_ms:.4f}, f32 kernel_ms {f32_ms:.4f} "
              f"(turns {', '.join(f'{t:.4f}' for t in turns)}), bf16 device "
              f"ms {'not recorded' if dev_ms is None else f'{dev_ms:.4f}'}, "
              f"plain twin {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})",
              flush=True)
    # the plain-rounding forms of the recurrence forwards
    for name, sh in BF16U_PREFILL:
        B, T, H = sh["B"], sh["T"], sh["H"]
        fwd = cl.lstm_forward if name == "lstm_fwd_bf16u" else \
            ct.lstm_tiled_forward
        g = torch.Generator().manual_seed(17)
        xp = (torch.randn((T, B, 4 * H), generator=g) * 0.5).to(device)
        U = (torch.randn((H, 4 * H), generator=g) / H ** 0.5).to(
            device).to(torch.bfloat16)
        h0 = (torch.randn((B, H), generator=g) * 0.5).to(device)
        c0 = (torch.randn((B, H), generator=g) * 0.5).to(device)
        lens = torch.randint(1, T + 1, (B,), generator=g)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(device)
        got = fwd(xp, U, h0, c0, mask)
        ref = cl.lstm_forward_reference(xp, U, h0, c0, mask)
        err = held_bf16(got, ref, f"{name} B={B} T={T} H={H}",
                        ("ys", "hT", "cT"), 0)
        kernel_ms = time_ms(torch, lambda: fwd(xp, U, h0, c0, mask), 50)
        plain_ms = time_ms(torch, lambda: cl.lstm_forward_reference(
            xp, U, h0, c0, mask), 3)
        dev_ms = profiled_ms(torch, lambda: fwd(xp, U, h0, c0, mask),
                             name.replace("_bf16u", ""), 20)
        nbytes = 4 * T * B * 4 * H + 2 * 4 * H * H + 4 * (T * B * H
                                                          + 4 * B * H + T * B)
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2 * T * B * H * 4 * H / PEAK_BF16_FLOPS
        out[name] = dict(max_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms,
                         device_ms=dev_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", library_ms=None)
        print(f"  {name} B={B} T={T} H={H} masked: ys/hT/cT within "
              f"{err:.3e}; kernel_ms {kernel_ms:.4f} (device "
              f"{'not recorded' if dev_ms is None else f'{dev_ms:.4f}'}), "
              f"plain twin {plain_ms:.4f} ms, bound "
              f"{out[name]['bound_ms']:.6f} ms ({out[name]['bound_by']})",
              flush=True)
    return out


# (b) config 1 trained as configs/ptb_char.sh runs it (bf16), captured,
# with checkpoints: a whole run, then the same command resumed from the
# oldest checkpoint it kept; every loss after that step must equal the
# whole run's bit for bit (K=1 host-fed: 24 steps, a checkpoint every 8
# calls; K=8 --device-data: 48 steps, every 2 calls). The K=1 run's last
# checkpoint is what (c) serves.
RESUME_RUNS = (("k1", ["--num-steps", "24", "--checkpoint-every", "8"]),
               ("k8-device-data", ["--num-steps", "48", "--steps-per-call",
                                   "8", "--device-data",
                                   "--checkpoint-every", "2"]))


def resume_phase(torch, cli, tmp):
    print("== phase 17b: config 1 in bf16 with checkpoints, resumed bit for "
          "bit", flush=True)
    return resumed_bit_for_bit(cli, tmp, CONFIG1_BF16_FLAGS,
                               RESUME_RUNS)["k1"]


def resumed_bit_for_bit(cli, tmp, flags, runs):
    """Each (name, extra flags) of ``runs``: the whole run of ``flags``
    with checkpoints, then a run resumed from the oldest checkpoint it
    kept, whose every logged loss must equal the whole run's bit for bit.
    Returns {name: the whole run's checkpoint directory}."""
    base = flags + ["--log-every", "1"]
    out = {}
    for name, extra in runs:
        whole_dir = os.path.join(tmp, f"{name}-whole")
        logs = {}

        def run(tag, flags):
            path = os.path.join(tmp, f"{name}-{tag}.jsonl")
            t0 = time.perf_counter()
            rc = cli.main(base + extra + flags + ["--jsonl", path])
            if rc != 0:
                fail(f"resume {name} {tag}: train exited {rc}")
            with open(path) as f:
                recs = [json.loads(line) for line in f]
            logs[tag] = {r["step"]: r["loss"] for r in recs
                         if "loss" in r and "note" not in r}
            return recs, time.perf_counter() - t0

        _, t_whole = run("whole", ["--checkpoint-dir", whole_dir])
        kept = sorted(int(n[5:-3]) for n in os.listdir(whole_dir)
                      if n.endswith(".pt"))
        mid = kept[0]
        res_dir = os.path.join(tmp, f"{name}-resumed")
        os.makedirs(res_dir)
        for suffix in (".pt", ".pt.sha256"):
            shutil.copy(os.path.join(whole_dir, f"step_{mid}{suffix}"),
                        res_dir)
        recs, t_res = run("resumed", ["--checkpoint-dir", res_dir,
                                      "--resume"])
        if not any(r.get("note") == f"resumed at step {mid}" for r in recs):
            fail(f"resume {name}: the run did not resume at step {mid}")
        whole, resumed = logs["whole"], logs["resumed"]
        want = [s for s in sorted(whole) if s > mid]
        if sorted(resumed) != want:
            fail(f"resume {name}: logged steps {sorted(resumed)} != {want}")
        diff = [s for s in want if whole[s] != resumed[s]]
        if diff:
            fail(f"resume {name}: losses differ at steps {diff}: whole "
                 f"{[whole[s] for s in diff]} resumed "
                 f"{[resumed[s] for s in diff]}")
        print(f"  {name}: checkpoints {kept} kept; resumed at step {mid}, "
              f"{len(want)} logged losses after it identical to the whole "
              f"run's (last {resumed[want[-1]]:.6f}); whole run {t_whole:.1f}"
              f" s, resumed {t_res:.1f} s", flush=True)
        out[name] = whole_dir
    return out


# (c) serve that checkpoint in bf16: `serve --http --compute-dtype bfloat16
# --checkpoint-dir <dir>` as a subprocess, plain and --speculative; phase
# 4's burst (6 greedy requests, prompt lengths 3-40, 32 new tokens, one
# with an eos_id) against the CPU plain generate of the same checkpoint in
# bf16; the server's own counters (GET /v1/stats) before and after
SERVE_BOOT_LIMIT_S = 180


def serve_cmd_burst(torch, cli, tgen, tlm, ckpt_dir, vocab, speculative):
    """Boot the serve command on the checkpoint, send the burst, stop it;
    returns (responses, wall s, launches during the burst by counter)."""
    import numpy as np

    cfg = tlm.LMConfig(vocab_size=vocab, hidden_size=128, num_layers=1,
                       compute_dtype="bfloat16")
    args = cli.build_serve_parser().parse_args(
        ["--http", "--checkpoint-dir", ckpt_dir, "--vocab-size", str(vocab),
         "--hidden-units", "128", "--num-layers", "1"])
    params = cli._checkpoint_params(args, tlm.init_lm(
        torch.Generator().manual_seed(0), cfg))
    rng = np.random.RandomState(0)
    lens = (3, 9, 17, 24, 33, 40)
    prompts = [rng.randint(0, vocab, size=t).tolist() for t in lens]
    n_new = 32
    refs = [tgen.generate(params, [q], cfg, max_new_tokens=n_new,
                          greedy=True, device="cpu")[0, len(q):].tolist()
            for q in prompts]
    eos_at = next((i for i in range(8, n_new)
                   if refs[5][i] not in refs[5][:i]), None)
    expect = [list(r) for r in refs]
    if eos_at is not None:
        expect[5] = refs[5][:eos_at + 1]
    cmd = [sys.executable, "-m", "lstm_tensorspark_torch", "serve", "--http",
           "--port", "0", "--compute-dtype", "bfloat16", "--checkpoint-dir",
           ckpt_dir, "--vocab-size", str(vocab), "--hidden-units", "128",
           "--num-layers", "1", "--num-slots", "32", "--prefill-buckets",
           "8,16,32,64", "--max-new-tokens", str(n_new)]
    if speculative:
        cmd.append("--speculative")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    lines, port = [], None
    t0 = time.perf_counter()
    try:
        while port is None:
            line = proc.stdout.readline()
            if not line:
                fail(f"serve exited {proc.wait()} before serving: "
                     + "".join(lines)[-3000:])
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
            if time.perf_counter() - t0 > SERVE_BOOT_LIMIT_S:
                fail(f"serve did not boot in {SERVE_BOOT_LIMIT_S} s")
        boot = time.perf_counter() - t0

        def stats():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                conn.request("GET", "/v1/stats")
                return json.loads(conn.getresponse().read())["engine"]
            finally:
                conn.close()

        before = stats()
        out = [None] * len(prompts)

        def one(i):
            body = {"prompt": prompts[i], "max_new_tokens": n_new,
                    "greedy": True}
            if i == 5 and eos_at is not None:
                body["eos_id"] = refs[5][eos_at]
            out[i] = post(port, body)

        t1 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t1
        after = stats()
    finally:
        proc.send_signal(2)  # SIGINT: the command's own shutdown
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    mode = "speculative" if speculative else "plain"
    for i, r in enumerate(out):
        if r is None or r[0] != 200:
            fail(f"serve {mode}: request {i} failed: {r}")
        if r[1]["tokens"] != expect[i]:
            fail(f"serve {mode}: request {i}: served tokens {r[1]['tokens']} "
                 f"!= the CPU plain generate of the checkpoint {expect[i]}")
    if after["window_form"] != "bfloat16":
        fail(f"serve {mode}: the engine runs the {after['window_form']} "
             "windows, not their bfloat16 forms")
    if after["reference_windows"] or after["spec_reference_windows"]:
        fail(f"serve {mode}: windows ran the plain twins on the card")
    launches = {k: after["launch_counts"].get(k, 0)
                - before["launch_counts"].get(k, 0)
                for k in after["launch_counts"]}
    return out, wall, launches, boot, expect


def bf16_serve_phase(torch, cli, tgen, tlm, ckpt_dir):
    print("== phase 17c: serve --compute-dtype bfloat16 --checkpoint-dir "
          "(the checkpoint of 17b), plain and speculative", flush=True)
    import glob

    vocab = None
    for path in glob.glob(os.path.join(ckpt_dir, "step_*.pt")):
        vocab = torch.load(path, weights_only=True)["params"][0].shape[0]
        break
    out = {}
    for speculative in (False, True):
        mode = "speculative" if speculative else "plain"
        res, wall, launches, boot, expect = serve_cmd_burst(
            torch, cli, tgen, tlm, ckpt_dir, vocab, speculative)
        want = "spec_window_bf16" if speculative else "decode_window_bf16"
        for name in (want, "lstm_fwd_bf16u"):
            if launches.get(name, 0) < 1:
                fail(f"serve {mode}: the burst launched {name} no time "
                     f"({launches})")
        stray = {k: v for k, v in launches.items()
                 if v and k not in ("decode_window_bf16", "spec_window_bf16",
                                    "lstm_fwd_bf16u")}
        if stray:
            fail(f"serve {mode}: the burst launched other kernels {stray}")
        tokens = sum(len(r[1]["tokens"]) for r in res)
        ttft = sorted(r[1]["ttft_ms"] for r in res)
        itl = sorted(r[1]["max_itl_ms"] or 0.0 for r in res)
        print(f"  {mode}: booted in {boot:.1f} s; 6 requests, tokens "
              f"identical to the CPU plain generate of the checkpoint in bf16"
              f" ({'request 5 stopped on its eos_id' if len(expect[5]) < 32 else 'no eos'});"
              f" {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
              f"tokens/s; ttft_ms {ttft}; max_itl_ms {itl}; launches during "
              f"the burst {launches}", flush=True)
        out[mode] = launches
    return out


def bf16_config3_phase(torch, tlm, tgen, cd, ct, serve, device):
    print("== phase 17d: phase 13's burst at config 3's width in bf16",
          flush=True)
    for c in (cd.counts_bf16, ct.fwd_bf16u_counts):
        c.reset()
    r = config3_burst(torch, tlm, tgen, cd, serve, device,
                      compute_dtype="bfloat16")
    prefill = ct.fwd_bf16u_counts.kernel
    if prefill < 1:
        fail("config 3 bf16: the prefills launched lstm_tiled_fwd_bf16u no "
             "time")
    print(f"  6 concurrent requests at L=2 H=650 V=33278 in bf16: tokens "
          f"identical to the plain generate on the CPU in bf16; "
          f"{burst_line(r)} (decode_window_bf16); lstm_tiled_fwd_bf16u "
          f"launches {prefill}", flush=True)
    return {"decode_window_bf16": r["launches"],
            "lstm_tiled_fwd_bf16u": prefill}


def phase17(torch, cli, tlm, tgen, cd, cs, cl, ct, serve, draft_config,
            device):
    """Phase 17 (a)-(d); returns the kernel report's rows of the four
    forms it adds."""
    t = bf16_windows_phase(torch, tlm, tgen, cd, cs, cl, ct, draft_config,
                           device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, tmp, True)
    ckpt_dir = timed(resume_phase, torch, cli, tmp)
    served = timed(bf16_serve_phase, torch, cli, tgen, tlm, ckpt_dir)
    c3 = timed(bf16_config3_phase, torch, tlm, tgen, cd, ct, serve, device)
    launches = {
        "decode_window_bf16": served["plain"].get("decode_window_bf16", 0)
        + served["speculative"].get("decode_window_bf16", 0)
        + c3["decode_window_bf16"],
        "spec_window_bf16": served["speculative"]["spec_window_bf16"],
        "lstm_fwd_bf16u": served["plain"]["lstm_fwd_bf16u"]
        + served["speculative"]["lstm_fwd_bf16u"],
        "lstm_tiled_fwd_bf16u": c3["lstm_tiled_fwd_bf16u"]}
    rows = []
    for name, (src, replaces) in BF16_SERVE_ROWS.items():
        r = t[name]
        main = r.get("config1", r)  # the windows: config 1, the main path
        rows.append({"name": name, "route": "cuda",
                     "source": f"lstm_tensorspark_torch/csrc/{src}.cu",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_err"], "ms": main["kernel_ms"],
                     "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"], "library_ms": None})
    return rows


BF16_SERVE_ROWS = {
    "decode_window_bf16": ("decode_window",
                           "lstm_tensorspark_tpu/ops/pallas_decode.py:109"),
    "spec_window_bf16": ("spec_window",
                         "lstm_tensorspark_tpu/ops/pallas_decode.py:367"),
    "lstm_fwd_bf16u": ("lstm_fwd",
                       "lstm_tensorspark_tpu/ops/pallas_lstm.py:528"),
    "lstm_tiled_fwd_bf16u": ("lstm_tiled_fwd",
                             "lstm_tensorspark_tpu/ops/pallas_lstm.py:670")}


# ---------------------------------------------------------------------------
# phase 18: config 4, the seq2seq forecaster, as configs/uci_forecast.sh
# runs it (F=8 series, context 168 h -> horizon 24 h, H=128, one layer,
# B=64, Adam 1e-3, clip 1.0, bf16 compute). Its path is the resident pair
# alone, two recurrences a step (the encoder at T=168, the decoder at
# T=24), the encoder's final carries the decoder's initial carries
# ---------------------------------------------------------------------------

CONFIG4 = dict(B=64, T=168, Td=24, F=8, H=128)
CONFIG4_FLAGS = ["train", "--dataset", "uci_electricity", "--hidden-units",
                 "128", "--num-layers", "1", "--batch-size", "64",
                 "--seq-len", "168", "--optimizer", "adam",
                 "--learning-rate", "1e-3", "--clip-norm", "1.0",
                 "--compute-dtype", "bfloat16"]
CONFIG4_F32_FLAGS = CONFIG4_FLAGS[:-1] + ["float32"]
CONFIG4_FIRST = 5
# the main runs: steps, an eval every so many calls, batches an eval
CONFIG4_STEPS, CONFIG4_EVAL_EVERY, CONFIG4_EVAL_BATCHES = 40, 20, 2
CONFIG4_RESUME_RUNS = (
    ("config4-k1", ["--num-steps", "12", "--checkpoint-every", "4"]),
    ("config4-k8-device-data", ["--num-steps", "32", "--steps-per-call",
                                "8", "--device-data",
                                "--checkpoint-every", "1"]))


def config4_references():
    """(name, flags) of config 4's CPU runs (HostRuns): the first losses
    of the bf16 and the float32 command."""
    return (("config4 bf16", first_flags(CONFIG4_FLAGS, CONFIG4_FIRST)),
            ("config4 f32", first_flags(CONFIG4_F32_FLAGS, CONFIG4_FIRST)))


class _Records:
    """A logger keeping a run's records (``cli.training(logger=)``)."""

    def __init__(self):
        self.recs = []

    def log(self, rec):
        self.recs.append(rec)


# phase 18a holds the bf16 chain end to end against the twins' chain
# (each rounds its own h, z and dz, so a rounding that falls the other way
# in the encoder travels into the decoder) as tests/test_torch_bf16.py
# holds the kernels' twins against JAX's Pallas kernels: gradients within
# 1e-2 of their max; each launch of the chain is held against its twin on
# the same inputs within phase 5's limits. The chain's weights are the
# forecaster's own init (forget bias 1): the gradient reaching h0, c0
# through 168 steps is ~1e-20 of what enters the encoder, where a share of
# its own max holds rounding noise, so dh0 and dc0 are held to a share of
# the larger of their max and the cotangents' entering the call
CHAIN_GRAD_SHARE = 1e-2
# phase 18a's encoder backward with a long memory: the forget gates'
# pre-activations raised by this much (sigmoid(5)^168 ~ 0.3), so dh0, dc0
# from zero dys are held at a size where a wrong hand-off would show
MEMORY_FORGET_SHIFT = 4.0


def forecast_pair_phase(torch, cl, device):
    """Phase 18a: the resident pair at config 4's shapes, chained under
    autograd as the forecaster chains it (the encoder at T=168 from
    non-zero carries, its final carries the decoder's at T=24, the
    encoder's ys unused), f32 and bf16: every launch of the chain held
    against its plain twin on the same inputs (phase 5's limits), and the
    chain's ys, hT, cT and the gradients of both xprojs, both Us, h0, c0
    and the encoder's inputs against the same chain through the twins;
    then each kernel timed at its shape (CUDA events) beside its twin and
    its bound."""
    print("== phase 18a: the resident pair at config 4's shapes, the "
          "encoder's carries into the decoder under autograd", flush=True)
    from lstm_tensorspark_torch.ops.lstm_cell import (LSTMParams, fuse_params,
                                                      init_lstm_params)

    B, T, Td, F, H = (CONFIG4[k] for k in ("B", "T", "Td", "F", "H"))

    def twin_fwd(xproj, U, h0, c0, mask, save_residuals=False):
        return cl.lstm_forward_reference(xproj, U, h0, c0, mask,
                                         save_residuals=save_residuals)

    def twin_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
        return cl.lstm_backward_reference(z, torch.cat([c0[None], cs[:-1]]),
                                          dys, U, dhT, dcT, mask)

    # (role, names, kernel's outputs, twin's outputs, cotangents' max)
    launches = []

    def held_fwd(xproj, U, h0, c0, mask, save_residuals=False):
        out = cl.lstm_forward(xproj, U, h0, c0, mask,
                              save_residuals=save_residuals)
        launches.append((f"fwd T={xproj.shape[0]}",
                         ("ys", "hT", "cT", "z", "cs"), out,
                         twin_fwd(xproj, U, h0, c0, mask, save_residuals),
                         None))
        return out

    def held_bwd(z, c0, cs, dys, U, dhT, dcT, mask):
        out = cl.lstm_backward(z, c0, cs, dys, U, dhT, dcT, mask)
        launches.append((f"bwd T={z.shape[0]}", ("dz", "dh0", "dc0"), out,
                         twin_bwd(z, c0, cs, dys, U, dhT, dcT, mask),
                         max(float(t.abs().max()) for t in (dys, dhT, dcT))))
        return out

    def grad_held(n, a, r, share, cot, label, bad):
        """max |a - r| of a float32 gradient, within ``share`` of the larger
        of max |r| and ``cot``."""
        err = float((a.float() - r.float()).abs().max())
        tol = share * max(float(r.abs().max()), cot)
        if not err <= tol:
            bad.append(f"{label}: {n} differs from the twin by {err:.3e} > "
                       f"{tol:.3e}")
        return err

    def function(fwd, bwd):
        class Pair(torch.autograd.Function):
            @staticmethod
            def forward(ctx, xproj, U, h0, c0, mask):
                return cl.recurrence_forward(ctx, fwd, xproj, U, h0, c0,
                                             mask)

            @staticmethod
            def backward(ctx, dys, dhT, dcT):
                return cl.recurrence_backward(ctx, bwd, dys, dhT, dcT)

        return lambda xproj, U, h0, c0, mask=None: cl.run_recurrence(
            Pair, fwd, xproj, U, h0, c0, mask)

    kernel_chain, twin_chain = (function(held_fwd, held_bwd),
                                function(twin_fwd, twin_bwd))
    g = torch.Generator().manual_seed(4)

    enc, dec = init_lstm_params(g, F, H), init_lstm_params(g, F, H)
    xs, xd = torch.randn(B, T, F, generator=g), torch.randn(B, Td, F,
                                                            generator=g)
    h0, c0 = (torch.randn(B, H, generator=g) * 0.5 for _ in range(2))
    wy = torch.randn(B, Td, H, generator=g)
    enc, dec = (LSTMParams(*(t.to(device).requires_grad_() for t in p))
                for p in (enc, dec))
    xs, h0, c0 = (t.to(device).requires_grad_() for t in (xs, h0, c0))
    xd, wy = xd.to(device), wy.to(device)
    grad_names = ("dxproj_enc", "dxproj_dec", "dU_enc", "dU_dec", "dh0",
                  "dc0", "dxs_enc")

    def chain(cd, recurrence):
        """(ys_e, hT_e, cT_e, ys_d, hT_d, cT_d), the gradients of
        ``grad_names`` and the operands of each recurrence."""
        outs, xps, Us, carry = [], [], [], (h0, c0)
        for p, x in ((enc, xs), (dec, xd)):
            fused = fuse_params(p)
            xproj = cl.project(x.transpose(0, 1), fused, cd).contiguous()
            ys, hT, cT = recurrence(xproj, fused.recurrent, *carry)
            outs += [ys, hT, cT]
            xps.append(xproj)
            Us.append(fused.recurrent)
            carry = (hT, cT)
        loss = (outs[3] * wy.transpose(0, 1)).sum()
        grads = torch.autograd.grad(loss, [*xps, *Us, h0, c0, xs])
        return ([o.detach() for o in outs], grads,
                [(xp.detach(), U.detach()) for xp, U in zip(xps, Us)])

    times, card = {}, card_line()
    for dt, cd in (("f32", None), ("bf16", torch.bfloat16)):
        label = f"config 4 chain {dt} B={B} T={T}+{Td} F={F} H={H}"
        launches.clear()
        got, ggot, ops = chain(cd, kernel_chain)
        ref, gref, _ = chain(cd, twin_chain)
        torch.cuda.synchronize()
        roles = [role for role, *_ in launches]
        if roles != [f"fwd T={T}", f"fwd T={Td}", f"bwd T={Td}",
                     f"bwd T={T}"]:
            fail(f"{label}: the chain launched {roles}")
        bad, per_launch = [], {}
        for role, names, out, twin, cot in launches:
            e = []
            for n, a, r in zip(names, out, twin):
                a = a.detach()  # the Function's outputs require grad
                if cd is None:
                    e.append(held(torch, n, a, r, f"{label} {role}",
                                  scaled=n in ("z", "dz", "dh0", "dc0")))
                elif n in ("dh0", "dc0"):
                    e.append(grad_held(n, a, r, BF16_GRAD_SHARE, cot,
                                       f"{label} {role}", bad))
                else:
                    e.append(bf16_held(torch, n, a, r, f"{label} {role}",
                                       n in ("z", "dz"), bad)[0])
            per_launch[role] = max(e)
        enc_cot = launches[-1][-1]  # the decoder's dh0, dc0 into the encoder
        errs = {}
        for n, a, r in zip(("ys_enc", "hT_enc", "cT_enc", "ys_dec",
                            "hT_dec", "cT_dec"), got, ref):
            errs[n] = float((a - r).abs().max())
            tol = ((LSTM_TOL if cd is None else BF16_TOL)
                   * (max(1.0, float(r.abs().max())) if n[:2] == "cT"
                      else 1.0))
            if not errs[n] <= tol:
                bad.append(f"{label}: {n} differs from the twins' chain by "
                           f"{errs[n]:.3e} > {tol:.3e}")
        for n, a, r in zip(grad_names, ggot, gref):
            if cd is None:
                errs[n] = grad_held(n, a, r, LSTM_TOL, 1.0, label, bad)
            else:
                errs[n] = grad_held(n, a, r, CHAIN_GRAD_SHARE,
                                    enc_cot if n in ("dh0", "dc0") else 0.0,
                                    f"{label}, the twins' chain", bad)
        # the encoder's backward with a long memory (forget gates raised):
        # from zero dys, dh0 and dc0 keep a size a wrong hand-off would move
        (xe, Ue), _ = ops
        xm = xe.float().clone()
        xm[..., H:2 * H] += MEMORY_FORGET_SHIFT
        xm = xm.to(xe.dtype)
        Um = Ue.to(xe.dtype)
        with torch.no_grad():
            _, _, _, zm, csm = cl.lstm_forward(xm, Um, h0.detach(),
                                               c0.detach(),
                                               save_residuals=True)
            cots = (torch.zeros(T, B, H, device=device),
                    *(t.detach().contiguous() for t in launches[-2][2][1:]))
            launches.clear()
            mg = held_bwd(zm, c0.detach(), csm, cots[0], Um, *cots[1:], None)
        _, names, out, twin, _ = launches[0]
        mem = {}
        for n, a, r in zip(names, out, twin):
            if cd is None:
                mem[n] = held(torch, n, a, r, f"{label} memory",
                              scaled=True)
            else:
                mem[n] = bf16_held(torch, n, a, r, f"{label} memory",
                                   n == "dz", bad)[0]
        if not float(mg[1].abs().max()) > 1e-3 * enc_cot:
            bad.append(f"{label} memory: max |dh0| "
                       f"{float(mg[1].abs().max()):.3e}: the gradient did "
                       "not reach t = 0")
        if bad:
            fail("; ".join(bad))
        print(f"  {label}: each launch against its twin, max |d| "
              + ", ".join(f"{k} {v:.2e}" for k, v in per_launch.items())
              + "; the chain against the twins' chain, max |d| "
              + ", ".join(f"{n} {v:.2e}" for n, v in errs.items())
              + f" (max |dh0| {float(gref[4].abs().max()):.3e}, the "
              f"cotangents into the encoder {enc_cot:.3e}); the encoder's "
              "backward with a long memory against its twin, max |d| "
              + ", ".join(f"{n} {v:.2e}" for n, v in mem.items())
              + f" (max |dh0| {float(mg[1].abs().max()):.3e})", flush=True)
        # each kernel at its shape: the encoder's backward from zero dys and
        # the decoder's dh0, dc0; the decoder's from its ys' cotangent
        bound = lstm_bound if cd is None else lstm_bound_bf16
        (xe, Ue), (xde, Ude) = ops
        Ue, Ude = Ue.to(xe.dtype), Ude.to(xde.dtype)
        ys_e, hT_e, cT_e = got[:3]
        with torch.no_grad():
            h0d, c0d = h0.detach(), c0.detach()
            _, _, _, ze, cse = cl.lstm_forward(xe, Ue, h0d, c0d,
                                               save_residuals=True)
            _, _, _, zd, csd = cl.lstm_forward(xde, Ude, hT_e, cT_e,
                                               save_residuals=True)
            zero = torch.zeros_like(ys_e)
            dhd = torch.zeros_like(hT_e)
            wyt = wy.transpose(0, 1).contiguous()
            _, dh0_d, dc0_d = cl.lstm_backward(zd, cT_e, csd, wyt, Ude, dhd,
                                               dhd)
        cases = {
            "fwd_enc": (T, "fwd", (xe, Ue, h0d, c0d)),
            "fwd_dec": (Td, "fwd", (xde, Ude, hT_e, cT_e)),
            "bwd_enc": (T, "bwd", (ze, c0d, cse, zero, Ue, dh0_d, dc0_d)),
            "bwd_dec": (Td, "bwd", (zd, cT_e, csd, wyt, Ude, dhd, dhd))}
        for name, (Tk, kind, args) in cases.items():
            if kind == "fwd":
                kern = functools.partial(cl.lstm_forward, *args,
                                         save_residuals=True)
                plain = functools.partial(twin_fwd, *args, None, True)
            else:
                kern = functools.partial(cl.lstm_backward, *args)
                plain = functools.partial(twin_bwd, *args, None)
            with torch.no_grad():
                ms = time_ms(torch, kern, 50)
                plain_ms = time_ms(torch, plain, 5)
            b_ms, b_by = bound(B, Tk, H, kind)
            times[dt, name] = ms
            print(f"  {dt} {name} (T={Tk}): kernel {ms:.4f} ms "
                  f"({1e3 * ms / Tk:.2f} us a step), twin {plain_ms:.4f} ms,"
                  f" bound {b_ms:.6f} ms ({b_by}; {card})",
                  flush=True)
    return times


def config4_phase(torch, cli, cl, cx, ct, device, host):
    """Phase 18b: ``configs/uci_forecast.sh`` through the CLI, captured (the
    default), in bf16 and in float32: the first losses against the CPU run
    of the same command, the launches of the main run (rows 3b and 4b, or 3
    and 4, twice a step and once an eval batch, no other kernel and no
    plain twin), K=8 ``--device-data --fused-eval`` against host-fed K=1,
    and resume bit for bit at K=1 and K=8 ``--device-data``. Returns the
    main runs' launches by counter."""
    print("== phase 18b: configs/uci_forecast.sh through the CLI, captured",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_config4_")
    atexit.register(shutil.rmtree, tmp, True)
    counters = all_counters(cl, cx, ct)
    S, E, EB = CONFIG4_STEPS, CONFIG4_EVAL_EVERY, CONFIG4_EVAL_BATCHES
    main_launches = {}
    refs = dict(config4_references())
    for dt, flags, stem in (("bf16", CONFIG4_FLAGS, "_bf16"),
                            ("f32", CONFIG4_F32_FLAGS, "")):
        recs, launches, warm = bf16_cli_run(
            cli, counters, tmp, f"config4 {dt} main", flags + [
                "--num-steps", str(S), "--log-every", "1", "--eval-every",
                str(E), "--eval-batches", str(EB), "--device", "cuda"])
        card_l = [r["loss"] for r in recs if "loss" in r][:CONFIG4_FIRST]
        cpu_l = host.losses(f"config4 {dt}", refs[f"config4 {dt}"])
        if len(card_l) != CONFIG4_FIRST or len(cpu_l) != CONFIG4_FIRST:
            fail(f"config4 {dt}: logged {len(card_l)} / {len(cpu_l)} first "
                 f"losses, not {CONFIG4_FIRST}")
        if dt == "bf16":
            gap = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
            limit = BF16_LOSS_RTOL
        else:
            gap = max(abs(a - b) for a, b in zip(card_l, cpu_l))
            limit = TRAIN_LOSS_TOL
        print(f"  config4 {dt}, first {CONFIG4_FIRST} losses: card "
              f"{[round(x, 6) for x in card_l]}; CPU "
              f"{[round(x, 6) for x in cpu_l]}; max "
              f"{'relative ' if dt == 'bf16' else ''}|d| {gap:.2e} (limit "
              f"{limit})", flush=True)
        if not gap <= limit:
            fail(f"config4 {dt}: card losses differ from the CPU run by "
                 f"{gap:.3e} > {limit}")
        evals = [r for r in recs if "eval_mse" in r and "note" not in r]
        final = recs[-1]
        if ([r["step"] for r in evals] != list(range(E, S + 1, E))
                or final.get("note") != "final"
                or not 0 < final["eval_mse"] < 1e9
                or not any(r.get("note") == "new best eval_mse"
                           for r in recs)):
            fail(f"config4 {dt}: eval records {evals}, final {final}")
        fw, bw = f"lstm_fwd{stem}", f"lstm_bwd{stem}"
        want = {fw: 2 * S + (S // E + 1) * EB, bw: 2 * S}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            fail(f"config4 {dt} main: launches {got} (the capture warm-ups' "
                 f"taken out), wanted {want}: the resident pair's {dt} "
                 "forms alone, twice a step and once an eval batch")
        for k in (fw, bw):
            main_launches[k] = launches[k] + warm[k]
        print(f"  config4 {dt} main ({S} steps, an eval every {E} of {EB} "
              f"batches): loss {card_l[0]:.4f} -> "
              f"{[r['loss'] for r in recs if 'loss' in r][-1]:.4f}, "
              f"eval_mse {evals[0]['eval_mse']:.4f} -> "
              f"{final['eval_mse']:.4f}; launches {got} (+ warm-ups "
              f"{ {k: v for k, v in warm.items() if v} })", flush=True)

    # K=8 --device-data --fused-eval against host-fed K=1: the same
    # windows, so the same losses; the fused eval against the host eval of
    # the same params
    def drive(flags, calls):
        for c in counters.values():
            c.reset()
        log = _Records()
        run = cli.training(flags[1:] + ["--device", "cuda"], logger=log)
        state, feed, ms = run.state, iter(run.feed), []
        fused = run.loop_kw["fused_eval"] is not None
        for i in range(calls):
            if fused:
                state, m = run.step(state, next(feed), i == calls - 1)
            else:
                state, m = run.step(state, next(feed))
            ms.append({k: float(v) for k, v in m.items()})
        warm = warmup_launches(log.recs, counters)
        launches = {k: c.kernel - warm[k] for k, c in counters.items()
                    if c.kernel - warm[k]}
        return ms, state, run, launches

    base = CONFIG4_FLAGS + ["--eval-every", "1", "--eval-batches", str(EB)]
    host_ms, host_state, host_run, host_l = drive(base, 16)
    dev_ms, dev_state, _, dev_l = drive(base + [
        "--steps-per-call", "8", "--device-data", "--fused-eval"], 2)
    d_loss = max(abs(a["loss_last"] - host_ms[8 * i + 7]["loss"])
                 for i, a in enumerate(dev_ms))
    ev = host_run.eval_fn(dev_state.params)
    d_eval = max(abs(dev_ms[-1][k] - ev[k]) for k in ("eval_mse",
                                                      "eval_mae"))
    want_host = {"lstm_fwd_bf16": 32, "lstm_bwd_bf16": 32}
    want_dev = {"lstm_fwd_bf16": 32 + EB, "lstm_bwd_bf16": 32}
    print(f"  config4 K=8 --device-data --fused-eval against host-fed K=1: "
          f"loss at steps 8, 16 max |d| {d_loss:.2e} (limit {CALLS_TOL}); "
          f"fused eval_mse {dev_ms[-1]['eval_mse']:.6f} against the host "
          f"eval's {ev['eval_mse']:.6f}, max |d| {d_eval:.2e} (limit "
          f"{FUSED_EVAL_TOL}); launches host-fed {host_l}, device-fed "
          f"{dev_l}", flush=True)
    if not (d_loss <= CALLS_TOL and d_eval <= FUSED_EVAL_TOL):
        fail("config4: the K=8 device-fed fused run differs from host-fed "
             "K=1")
    if host_l != want_host or dev_l != want_dev:
        fail(f"config4: launches host-fed {host_l} (wanted {want_host}), "
             f"device-fed {dev_l} (wanted {want_dev})")
    resumed_bit_for_bit(cli, tmp, CONFIG4_FLAGS + ["--device", "cuda"],
                        CONFIG4_RESUME_RUNS)
    return main_launches


def config4_rate_phase(torch, cli):
    """Phase 18c: steps/s (host clock over 60 calls), device ms a step and
    the idle share (torch.profiler over 10 calls) of
    ``configs/uci_forecast.sh`` eager and captured, in turns (eager,
    captured, captured, eager)."""
    print("== phase 18c: configs/uci_forecast.sh, eager against captured",
          flush=True)
    flags = CONFIG4_FLAGS + ["--device", "cuda"]
    runs = {"eager": cli_calls(cli, flags, graph=False),
            "captured": cli_calls(cli, flags)}
    for calls in runs.values():
        calls(3)
    got = {}
    for mode in ("eager", "captured", "captured", "eager"):
        got.setdefault(mode, []).append(rate_and_profile(torch, runs[mode],
                                                         60, 10))
    print(f"  config4 bf16 in turns (eager, captured, captured, eager; "
          f"{card_line()}): " + "; ".join(
              f"{mode} " + ", ".join(
                  f"{s:.2f} steps/s, device "
                  + ("not measured" if d is None else f"{d:.4f} ms a step, "
                     f"idle {i:.3f}") for s, d, i in got[mode])
              for mode in ("eager", "captured")), flush=True)
    parts = step_parts(torch, runs["captured"], 10)
    print("  config4 captured step by part (ms a step over 10 calls): "
          + ("not measured" if parts is None else "; ".join(
              f"{k} {v:.4f}" for k, v in parts.items())), flush=True)
    return got


def phase18(torch, cli, cl, cx, ct, device, host):
    """Phase 18 (a)-(c); returns the launches of the main runs by
    counter."""
    timed(forecast_pair_phase, torch, cl, device)
    launches = timed(config4_phase, torch, cli, cl, cx, ct, device, host)
    timed(config4_rate_phase, torch, cli)
    return launches



# ---------------------------------------------------------------------------
# phase 19: serve as `cli serve` runs it by default — kept sessions over the
# host and disk session tiers, the prefix cache and chunked prefill
# ---------------------------------------------------------------------------

# (a) multi-turn conversations at config 1 over 8 slots and a host tier of
# 8: a turn's prompt is the last token served plus a user fragment, and
# the tokens of every turn must equal the CPU plain generate of the whole
# context so far; turns 1 and 2 keep the session, turn 3 ends it
SESSION_CONVS, SESSION_TURNS, SESSION_NEW = 24, 3, 8
# (b) 16 prompts: a 96-token system prompt plus suffixes of 8-24 tokens;
# (c) long prompts chunked at 64 beside 8 short sessions that decode;
# (d) 4 kept sessions across a SIGKILL of the serve command; (e) config 3's
# width in bf16, 4 conversations x 2 turns, one 200 tokens long
PREFIX_SHARED, PREFIX_PROMPTS = 96, 16
LONG_PROMPTS, LONG_CHUNK, SHORT_SESSIONS = (300, 517, 800, 1000), 64, 8
RESTART_SESSIONS = 4
# the prefill forwards held from non-zero carries over masked rows: the
# resident f32 and bf16u forms at a config 1 prefill batch, the tiled bf16u
# form at config 3's width
SESSION_HOLDS = (("lstm_fwd", dict(B=8, T=16, H=128), None),
                 ("lstm_fwd_bf16u", dict(B=8, T=16, H=128), "bfloat16"),
                 ("lstm_tiled_fwd_bf16u", dict(B=4, T=64, H=650),
                  "bfloat16"))
# the kernels phase 19's runs must launch
SESSION_KERNELS = ("decode_window", "spec_window", "lstm_fwd",
                   "decode_window_bf16", "lstm_fwd_bf16u",
                   "lstm_tiled_fwd_bf16u")


def session_holds_phase(torch, cl, ct, device):
    print("== phase 19: the prefill forwards from non-zero carries over "
          "masked rows vs their plain twins", flush=True)
    for name, sh, dtype in SESSION_HOLDS:
        B, T, H = sh["B"], sh["T"], sh["H"]
        (xp, U, h0, c0, mask), _ = lstm_inputs(torch, B, T, H, True, 19,
                                               device)
        if dtype is not None:
            U = U.to(torch.bfloat16)
        fwd = ct.lstm_tiled_forward if "tiled" in name else cl.lstm_forward
        got = fwd(xp, U, h0, c0, mask)
        ref = cl.lstm_forward_reference(xp, U, h0, c0, mask)
        label = f"{name} B={B} T={T} H={H} masked, non-zero carries"
        if dtype is None:
            err = max(held(torch, name, g, r, label, False)
                      for g, r in zip(got, ref))
        else:
            err = held_bf16(got, ref, label, ("ys", "hT", "cT"), 0)
        print(f"  {label}: ys/hT/cT within {err:.3e} (limit "
              f"{LSTM_TOL if dtype is None else BF16_TOL})", flush=True)


class Counted:
    """The launches of the runs inside ``with``: every counter set to 0
    on entry, read on exit; a plain twin run on the card fails the run."""

    def __init__(self, label):
        self.label = label
        self.launches = {}

    def __enter__(self):
        from lstm_tensorspark_torch.kernels import LaunchCounts

        for c in LaunchCounts.every():
            c.reset()
        return self

    def __exit__(self, *exc):
        from lstm_tensorspark_torch.kernels import LaunchCounts

        if exc[0] is not None:
            return False
        plain = {c.name: c.reference for c in LaunchCounts.every()
                 if c.reference}
        if plain:
            fail(f"{self.label}: plain twins ran on the card: {plain}")
        self.launches = {c.name: c.kernel for c in LaunchCounts.every()
                         if c.kernel}
        return False


def cpu_generate(tgen, params_cpu, cfg, context, n_new):
    return tgen.generate(params_cpu, [list(context)], cfg,
                         max_new_tokens=n_new, greedy=True,
                         device="cpu")[0, len(context):].tolist()


def conversations(tgen, params_cpu, cfg, n_conv, turns, first_lens, n_new,
                  seed):
    """Each conversation's turn prompts and the CPU plain generate of the
    whole context before each turn (the tokens that turn must serve)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    V = cfg.vocab_size
    out = []
    for i in range(n_conv):
        context, prompts, refs = [], [], []
        for t in range(turns):
            if t == 0:
                prompt = rng.randint(0, V, size=first_lens[i]).tolist()
            else:
                prompt = [refs[-1][-1]] + rng.randint(
                    0, V, size=int(rng.randint(2, 9))).tolist()
            context = context + prompt if t == 0 else \
                context + refs[-1][:-1] + prompt
            prompts.append(prompt)
            refs.append(cpu_generate(tgen, params_cpu, cfg, context, n_new))
        out.append((prompts, refs))
    return out


def run_conversations(server, convs, n_new, label, flush_turns=False):
    """Serve every conversation's turns in order (a thread each, all
    concurrent), keeping the session until its last turn; fails unless
    every turn's tokens equal its reference. Returns the responses.
    ``flush_turns``: land every spill at each turn boundary."""
    got = [[None] * len(p) for p, _ in convs]
    errors = []

    def flush():
        if not server.engine.tiers.flush(timeout=60):
            errors.append("the tiers did not flush within 60 s")

    # every conversation finishes a turn before any starts the next, so
    # the turns after the first find their sessions spread over the tiers.
    # The worker polls, so without a flush how many spills have landed,
    # and so how many overflowed to disk, depends on the host's timing:
    # a flush at the boundary makes the next turn find sessions on disk,
    # while sessions evicted within a turn still fill from pending spills
    turn_done = threading.Barrier(len(convs),
                                  action=flush if flush_turns else None)

    def one(i):
        prompts, _ = convs[i]
        sid = None
        try:
            for t, prompt in enumerate(prompts):
                req = server.generate(
                    prompt, max_new_tokens=n_new, session_id=sid,
                    keep_session=t < len(prompts) - 1, timeout=300)
                sid = req.session_id
                got[i][t] = req
                turn_done.wait(300)
        except Exception as e:  # noqa: BLE001 — reported below
            turn_done.abort()
            errors.append(f"conversation {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(convs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{label}: {errors or 'a conversation did not finish'}")
    for i, (prompts, refs) in enumerate(convs):
        for t, ref in enumerate(refs):
            if got[i][t].tokens != ref:
                fail(f"{label}: conversation {i} turn {t + 1}: served "
                     f"{got[i][t].tokens} != the CPU plain generate of the "
                     f"whole context {ref}")
    return got


def tier_line(stats):
    tiers = stats["tiers"]
    return (f"fills host {tiers['fills']['host']} (of them from a pending "
            f"spill {tiers['fills_pending']}), disk {tiers['fills']['disk']};"
            f" spills host {tiers['spills']['host']}, disk "
            f"{tiers['spills']['disk']}; misses {tiers['misses']}, lost "
            f"{tiers['lost']}; spill ms mean "
            f"{1e3 * tiers['spill_seconds']['sum'] / max(1, tiers['spill_seconds']['count']):.3f}"
            f" max {1e3 * tiers['spill_seconds']['max']:.3f}; fill ms mean "
            f"{1e3 * tiers['fill_seconds']['sum'] / max(1, tiers['fill_seconds']['count']):.3f}"
            f" max {1e3 * tiers['fill_seconds']['max']:.3f}")


def multi_turn_phase(torch, tlm, tgen, serve, device, compute_dtype):
    print(f"== phase 19a: {SESSION_CONVS} conversations x {SESSION_TURNS} "
          f"turns at config 1 in {compute_dtype} over 8 slots, a host tier "
          "of 8 and a disk tier", flush=True)
    import dataclasses

    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    rng = np.random.RandomState(7)
    firsts = rng.randint(4, 25, size=SESSION_CONVS).tolist()
    convs = conversations(tgen, params_cpu, cfg, SESSION_CONVS, SESSION_TURNS,
                          firsts, SESSION_NEW, 19)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sessions_")
    atexit.register(shutil.rmtree, tmp, True)
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=8,
                               rng_seed=0, prefix_cache=True,
                               tiered_cache=True, host_tier_entries=8,
                               session_dir=tmp)
    server = serve.ServeServer(engine, max_active=8)
    server.warmup(prompt_lens=tuple(sorted({len(p) for ps, _ in convs
                                            for p in ps})))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Counted(f"phase 19a {compute_dtype}") as counted:
        with server:
            run_conversations(server, convs, SESSION_NEW,
                              f"phase 19a {compute_dtype}", flush_turns=True)
    wall = time.perf_counter() - t0
    stats = server.stats()
    fills = stats["engine"]["tiers"]["fills"]
    continued = SESSION_CONVS * (SESSION_TURNS - 1)
    in_slot = continued - fills["host"] - fills["disk"]
    if stats["engine"]["tiers"]["misses"] or in_slot < 0:
        fail(f"phase 19a {compute_dtype}: a continuation missed its state:"
             f" {stats['engine']['tiers']}")
    if not fills["host"] or not fills["disk"]:
        fail(f"phase 19a {compute_dtype}: no continuation filled from "
             f"{'host RAM' if not fills['host'] else 'disk'}: {fills}")
    print(f"  {SESSION_CONVS * SESSION_TURNS} turns in {wall:.3f} s, every "
          f"turn identical to the CPU plain generate of its whole context; "
          f"{continued} continuations: {in_slot} from their device slot, "
          f"{tier_line(stats['engine'])}; launches {counted.launches}",
          flush=True)
    return counted.launches


def prefix_burst(server, prompts, warm, n_new):
    """The warm request (it inserts the shared prefix), then the prompts
    concurrently; returns (responses, TTFT ms of each)."""
    server.generate(warm, max_new_tokens=n_new, timeout=300)
    out = [None] * len(prompts)

    def one(i):
        out[i] = server.generate(prompts[i], max_new_tokens=n_new,
                                 timeout=300)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if any(r is None for r in out):
        fail("phase 19b: a request failed")
    return out, sorted(1e3 * (r.t_first_token - r.t_submit) for r in out)


def percentile(xs, q):
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def shared_prefix_phase(torch, tlm, tgen, serve, draft_config, device):
    print(f"== phase 19b: {PREFIX_PROMPTS} prompts sharing a "
          f"{PREFIX_SHARED}-token prefix, prefix cache off, on, and on with "
          "speculative windows", flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    rng = np.random.RandomState(21)
    shared = rng.randint(0, cfg.vocab_size, size=PREFIX_SHARED).tolist()
    # the warm request's prompt ends within a stride of the shared prefix,
    # so its one insert is the shared prefix itself
    warm = shared + rng.randint(0, cfg.vocab_size, size=8).tolist()
    prompts = [shared + rng.randint(0, cfg.vocab_size,
                                    size=int(rng.randint(8, 25))).tolist()
               for _ in range(PREFIX_PROMPTS)]
    n_new = 16
    refs = [cpu_generate(tgen, params_cpu, cfg, p, n_new) for p in prompts]
    dcfg = draft_config(cfg)
    dparams = tlm.init_lm(torch.Generator().manual_seed(1), dcfg)
    launches, rows = {}, {}
    for mode in ("off", "on", "on+speculative"):
        engine = serve.ServeEngine(params_cpu, cfg, device=device,
                                   num_slots=32, rng_seed=0,
                                   prefix_cache=mode != "off")
        kw = {}
        if mode.endswith("speculative"):
            engine.attach_draft(dparams, dcfg)
            kw = {"speculative": True, "spec_ladder": (2, 4)}
        server = serve.ServeServer(engine, max_active=16, **kw)
        server.warmup(prompt_lens=tuple(sorted({len(p) for p in prompts}
                                               | {len(warm)})))
        torch.cuda.synchronize()
        with Counted(f"phase 19b {mode}") as counted:
            with server:
                out, ttft = prefix_burst(server, prompts, warm, n_new)
        for i, r in enumerate(out):
            if r.tokens != refs[i]:
                fail(f"phase 19b prefix {mode}: request {i}: served "
                     f"{r.tokens} != the CPU plain generate {refs[i]}")
        for k, v in counted.launches.items():
            launches[k] = launches.get(k, 0) + v
        st = server.stats()
        px = st["engine"]["prefix_cache"] or {}
        rows[mode] = (px.get("hits", 0), st["batcher"]["prefix_tokens_saved"])
        print(f"  prefix cache {mode}: tokens identical to the CPU plain "
              f"generate; hits {px.get('hits', 0)}, misses "
              f"{px.get('misses', 0)}, inserts {px.get('inserts', 0)}, "
              f"prefix_tokens_saved {st['batcher']['prefix_tokens_saved']}, "
              f"prefill tokens computed "
              f"{st['batcher']['prefill_tokens_computed']}; TTFT ms p50 "
              f"{percentile(ttft, 50):.3f} p99 {percentile(ttft, 99):.3f}; "
              f"spec windows {st['batcher']['spec_windows_dispatched']}; "
              f"launches {counted.launches}", flush=True)
    if rows["on"][0] < PREFIX_PROMPTS or rows["on"][1] < (
            PREFIX_PROMPTS * PREFIX_SHARED):
        fail(f"phase 19b: the prompts did not resume from the shared prefix "
             f"(hits, tokens saved) = {rows['on']}")
    return launches


def long_prompt_phase(torch, tlm, tgen, serve, device):
    print(f"== phase 19c: prompts of {', '.join(map(str, LONG_PROMPTS))} "
          f"tokens chunked at {LONG_CHUNK} beside {SHORT_SESSIONS} decoding "
          "sessions", flush=True)
    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    rng = np.random.RandomState(23)
    V = cfg.vocab_size
    longs = [rng.randint(0, V, size=t).tolist() for t in LONG_PROMPTS]
    shorts = [rng.randint(0, V, size=int(rng.randint(4, 13))).tolist()
              for _ in range(SHORT_SESSIONS)]
    n_long, n_short = 8, 96
    long_refs = [cpu_generate(tgen, params_cpu, cfg, p, n_long)
                 for p in longs]
    short_refs = [cpu_generate(tgen, params_cpu, cfg, p, n_short)
                  for p in shorts]
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=32,
                               rng_seed=0, prefix_cache=True,
                               tiered_cache=True)
    server = serve.ServeServer(engine, max_active=16,
                               prefill_chunk=LONG_CHUNK)
    server.warmup(prompt_lens=tuple(sorted({len(p) for p in longs + shorts})))
    torch.cuda.synchronize()
    b = server.batcher
    with Counted("phase 19c") as counted:
        with server:
            short_reqs = [serve.Request(p, n_short) for p in shorts]
            for r in short_reqs:
                b.submit(r)
            t_end = time.perf_counter() + 60
            while not all(r.t_first_token for r in short_reqs):
                if time.perf_counter() > t_end:
                    fail("phase 19c: the short sessions did not start")
                time.sleep(0.001)
            chunks0 = b.prefill_chunks_dispatched
            t_long = time.perf_counter()
            long_reqs = [serve.Request(p, n_long) for p in longs]
            for r in long_reqs:
                b.submit(r)
            for r in short_reqs + long_reqs:
                if not r.done.wait(300):
                    fail("phase 19c: a request did not finish")
            chunks = b.prefill_chunks_dispatched - chunks0
    for r, ref, what in [(r, ref, "long") for r, ref in zip(long_reqs,
                                                             long_refs)] + \
            [(r, ref, "short") for r, ref in zip(short_reqs, short_refs)]:
        if r.error is not None or r.tokens != ref:
            fail(f"phase 19c: a {what} request: {r.error or r.tokens} != "
                 f"the CPU plain generate {ref}")
    t_prefilled = max(r.t_first_token for r in long_reqs)
    gaps = [b2 - a for r in short_reqs
            for a, b2 in zip(r.t_tokens, r.t_tokens[1:])
            if t_long <= a < t_prefilled]
    ttft = [1e3 * (r.t_first_token - r.t_submit) for r in long_reqs]
    print(f"  tokens identical to the CPU plain generate; {chunks} head-less "
          f"chunk dispatches for the long prompts; their TTFT ms "
          f"{', '.join(f'{t:.3f}' for t in ttft)}; the short sessions' "
          f"largest gap between tokens while they prefilled "
          f"{1e3 * max(gaps, default=0.0):.3f} ms; launches "
          f"{counted.launches}", flush=True)
    # the long prompts' chunks ride in one batch: the longest sets the count
    if chunks < max(LONG_PROMPTS) // LONG_CHUNK:
        fail(f"phase 19c: only {chunks} chunk dispatches")
    return counted.launches


def boot_serve(cmd, label):
    """Start the serve command; returns (process, port, boot s)."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    lines, port = [], None
    t0 = time.perf_counter()
    while port is None:
        line = proc.stdout.readline()
        if not line:
            fail(f"{label}: serve exited {proc.wait()} before serving: "
                 + "".join(lines)[-3000:])
        lines.append(line)
        if line.startswith("serving on http://"):
            port = int(line.split()[2].rsplit(":", 1)[1])
        if time.perf_counter() - t0 > SERVE_BOOT_LIMIT_S:
            proc.kill()
            fail(f"{label}: serve did not boot in {SERVE_BOOT_LIMIT_S} s")
    # drain the rest of its output so the pipe never fills
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc, port, time.perf_counter() - t0


def get_stats(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def post_all(port, bodies):
    out = [None] * len(bodies)

    def one(i):
        out[i] = post(port, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


def restart_phase(torch, tlm, tgen, serve, device):
    print(f"== phase 19d: {RESTART_SESSIONS} kept sessions over HTTP across "
          "a SIGKILL of `serve --http --session-dir` and a boot on the same "
          "directory", flush=True)
    import signal

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    n_new = 12
    convs = conversations(tgen, params_cpu, cfg, RESTART_SESSIONS, 2,
                          (5, 11, 19, 30), n_new, 29)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    atexit.register(shutil.rmtree, tmp, True)
    cmd = [sys.executable, "-m", "lstm_tensorspark_torch", "serve", "--http",
           "--port", "0", "--vocab-size", str(cfg.vocab_size),
           "--hidden-units", str(cfg.hidden_size), "--num-layers",
           str(cfg.num_layers), "--compute-dtype", "float32", "--seed", "0",
           "--num-slots", "16", "--prefill-buckets", "8,16,32,64",
           "--batch-buckets", "1,2,4,8", "--session-dir", tmp,
           "--device", device.type]
    launches = {}

    def burst(port, turn, sids):
        before = get_stats(port)["engine"]["launch_counts"]
        bodies = [{"prompt": prompts[turn], "max_new_tokens": n_new,
                   "greedy": True, "keep_session": turn == 0,
                   **({} if sids is None else {"session_id": sids[i]})}
                  for i, (prompts, _) in enumerate(convs)]
        out = post_all(port, bodies)
        after = get_stats(port)
        for k, v in after["engine"]["launch_counts"].items():
            launches[k] = launches.get(k, 0) + v - before.get(k, 0)
        for i, r in enumerate(out):
            if r is None or r[0] != 200:
                fail(f"phase 19d turn {turn + 1}: request {i} failed: {r}")
            if r[1]["tokens"] != convs[i][1][turn]:
                fail(f"phase 19d turn {turn + 1}: session {i}: served "
                     f"{r[1]['tokens']} != the uninterrupted run "
                     f"{convs[i][1][turn]}")
        return [r[1]["session_id"] for r in out], after

    proc, port, boot1 = boot_serve(cmd, "phase 19d (first boot)")
    try:
        sids, _ = burst(port, 0, None)
        paths = [serve.session_file_path(tmp, sid) for sid in sids]
        t_end = time.perf_counter() + 30
        while not all(os.path.exists(p) for p in paths):
            if time.perf_counter() > t_end:
                fail("phase 19d: the kept sessions' files were not written")
            time.sleep(0.01)
        waited = 30 - (t_end - time.perf_counter())
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    proc, port, boot2 = boot_serve(cmd, "phase 19d (second boot)")
    try:
        _, stats = burst(port, 1, sids)
    finally:
        proc.send_signal(2)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    tiers = stats["engine"]["tiers"]
    if tiers["fills"]["disk"] != RESTART_SESSIONS:
        fail(f"phase 19d: {tiers['fills']} fills after the restart, expected "
             f"{RESTART_SESSIONS} from disk")
    print(f"  booted in {boot1:.1f} s, files after {waited:.3f} s, SIGKILL, "
          f"booted again in {boot2:.1f} s: every continued session identical"
          f" to the uninterrupted run; {tier_line(stats['engine'])}; "
          f"launches {launches}", flush=True)
    return launches


def config3_sessions_phase(torch, tlm, tgen, serve, device):
    print("== phase 19e: 4 conversations x 2 turns at config 3's width in "
          f"bf16, one of 200 tokens, chunked at {LONG_CHUNK}", flush=True)
    import dataclasses

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG3)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    convs = conversations(tgen, params_cpu, cfg, 4, 2, (200, 9, 17, 24), 8,
                          31)
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=8,
                               rng_seed=0, prefix_cache=True,
                               tiered_cache=True)
    server = serve.ServeServer(engine, max_active=4, prefill_chunk=LONG_CHUNK)
    server.warmup(prompt_lens=tuple(sorted({len(p) for ps, _ in convs
                                            for p in ps})))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Counted("phase 19e") as counted:
        with server:
            run_conversations(server, convs, 8, "phase 19e")
    st = server.stats()
    print(f"  8 turns in {time.perf_counter() - t0:.3f} s, identical to the "
          f"CPU plain generate in bf16 of each whole context; "
          f"{st['batcher']['prefill_chunks_dispatched']} head-less chunks; "
          f"launches {counted.launches}", flush=True)
    return counted.launches


def phase19(torch, tlm, tgen, cl, ct, serve, draft_config, device):
    """Phase 19 (holds, a-e); returns the launches of its runs by
    counter, and fails unless each of SESSION_KERNELS launched."""
    t0 = time.perf_counter()
    timed(session_holds_phase, torch, cl, ct, device)
    launches = {}
    for got in (timed(multi_turn_phase, torch, tlm, tgen, serve, device,
                      "float32"),
                timed(multi_turn_phase, torch, tlm, tgen, serve, device,
                      "bfloat16"),
                timed(shared_prefix_phase, torch, tlm, tgen, serve,
                      draft_config, device),
                timed(long_prompt_phase, torch, tlm, tgen, serve, device),
                timed(restart_phase, torch, tlm, tgen, serve, device),
                timed(config3_sessions_phase, torch, tlm, tgen, serve,
                      device)):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    missing = [k for k in SESSION_KERNELS if not launches.get(k)]
    if missing:
        fail(f"phase 19: {missing} launched no time ({launches})")
    print(f"  phase 19: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 20: serve under load as `cli serve` runs by default — admission
# classes and deadlines behind the one-replica router, the registry's
# GET /metrics, and `serve --loadgen`
# ---------------------------------------------------------------------------

# (a) a burst of LOAD_BURST requests over HTTP at --queue-size LOAD_QUEUE
# (best_effort sheds at half of it), every other one best_effort; every
# eighth asks for more tokens with a deadline, keeping its session (a
# timeout must discard it); one request before the burst has a 1 ms
# deadline. In float32 the deadline requests ask for 8,192 tokens in 80
# ms, which they cannot meet, and their partial output is held to the CPU
# plain generate whatever its length. In bfloat16 a greedy run on the card
# departs from the CPU's bf16 twin after some hundred tokens (a near tie
# of the argmax: the bf16 forms hold carries to 1e-3, not bit for bit), so
# there they ask for 64 tokens in 10 ms: a timeout is then likely during
# the burst, and either outcome is held to the CPU
LOAD_QUEUE, LOAD_BURST, LOAD_NEW = 8, 32, 24
LOAD_LONG = {"float32": (8192, 0.08), "bfloat16": (64, 0.01)}
# (b) `serve --loadgen`, closed-loop and --idle-churn
LOADGEN_FLAGS = ["--sessions", "8", "--requests-per-session", "4",
                 "--priority-frac", "0.5", "--retry-max", "2"]
# the kernels phase 20's runs must launch
LOAD_KERNELS = ("decode_window", "lstm_fwd", "decode_window_bf16",
                "lstm_fwd_bf16u")
CONFIG1_FLAGS = ["--vocab-size", str(CONFIG1["vocab"]), "--hidden-units",
                 str(CONFIG1["hidden"]), "--num-layers",
                 str(CONFIG1["layers"]), "--seed", "0"]


def post_with_headers(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def admission_phase(torch, tlm, tgen, serve, device, compute_dtype):
    print(f"== phase 20a: a burst of {LOAD_BURST} requests at config 1 in "
          f"{compute_dtype} over HTTP, --queue-size {LOAD_QUEUE}, half "
          "best_effort, some with deadlines", flush=True)
    import dataclasses

    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    rng = np.random.RandomState(37)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=int(rng.randint(3, 25))).tolist()
               for _ in range(LOAD_BURST + 1)]
    long_new, long_deadline = LOAD_LONG[compute_dtype]
    bodies = []
    for i, p in enumerate(prompts[1:]):
        body = {"prompt": p, "max_new_tokens": LOAD_NEW, "greedy": True,
                "class": "best_effort" if i % 2 else "priority"}
        if i % 8 == 3:
            body.update(max_new_tokens=long_new, keep_session=True,
                        deadline_s=long_deadline)
        bodies.append(body)
    first = {"prompt": prompts[0], "max_new_tokens": long_new,
             "greedy": True, "deadline_s": 0.001}
    # as `cli serve` builds it: prefix cache and tiers on, 64 slots
    engine = serve.ServeEngine(params_cpu, cfg, device=device, num_slots=64,
                               rng_seed=0, prefix_cache=True,
                               tiered_cache=True)
    server = serve.ServeServer(engine, max_active=16, queue_size=LOAD_QUEUE)
    server.warmup(prompt_lens=tuple(sorted({len(p) for p in prompts})))
    torch.cuda.synchronize()
    httpd = serve.make_http_server(server, "127.0.0.1", 0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    out = [None] * len(bodies)

    def one(i):
        out[i] = post_with_headers(port, bodies[i])

    t0 = time.perf_counter()
    try:
        with Counted(f"phase 20a {compute_dtype}") as counted:
            with server:
                lone = post_with_headers(port, first)
                threads = [threading.Thread(target=one, args=(i,))
                           for i in range(len(bodies))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
    finally:
        httpd.shutdown()
        httpd.server_close()
    wall = time.perf_counter() - t0
    label = f"phase 20a {compute_dtype}"
    if lone[0] != 504 or lone[2].get("code") != "deadline_exceeded":
        fail(f"{label}: the 1 ms deadline got {lone[0]} {lone[2]}")
    results = [(first, lone)] + list(zip(bodies, out))
    shed = {"priority": 0, "best_effort": 0}
    timeouts, partial, done_tokens, ttft, retry = 0, 0, 0, [], []
    kept = set()  # sessions of completed keep_session requests
    for body, r in results:
        if r is None:
            fail(f"{label}: a request got no reply")
        status, headers, reply = r
        klass = body.get("class", "priority")
        if status == 429:
            hdr = int(headers.get("Retry-After", "0"))
            full = f"bound {LOAD_QUEUE})" in reply["error"]
            if reply["code"] != "queue_full" or hdr < 1 or not (
                    reply["retry_after_s"] >= 0.05):
                fail(f"{label}: a shed without its Retry-After: {headers} "
                     f"{reply}")
            if klass == "priority" and not full:
                fail(f"{label}: priority shed below the full bound: "
                     f"{reply['error']}")
            shed[klass] += 1
            retry.append((hdr, reply["retry_after_s"]))
        elif status == 504:
            if reply["code"] != "deadline_exceeded":
                fail(f"{label}: 504 {reply}")
            got = reply["tokens"]
            ref = cpu_generate(tgen, params_cpu, cfg, body["prompt"],
                               len(got)) if got else []
            if got != ref:
                fail(f"{label}: a timed-out request's partial tokens {got} "
                     f"are not a prefix of the CPU plain generate {ref}")
            timeouts += 1
            partial += bool(got)
        elif status == 200:
            ref = cpu_generate(tgen, params_cpu, cfg, body["prompt"],
                               body["max_new_tokens"])
            if reply["tokens"] != ref:
                fail(f"{label}: served {reply['tokens']} != the CPU plain "
                     f"generate {ref}")
            done_tokens += len(reply["tokens"])
            ttft.append(reply["ttft_ms"])
            if body.get("keep_session"):
                kept.add(reply["session_id"])
        else:
            fail(f"{label}: status {status}: {reply}")
    if not shed["best_effort"]:
        fail(f"{label}: the burst shed no best_effort request")
    bstats, rstats = server.batcher.stats(), server.router.stats()
    if rstats["shed_by_class"] != shed or bstats["timed_out"] != timeouts:
        fail(f"{label}: the router's sheds {rstats['shed_by_class']} or the "
             f"batcher's timeouts {bstats['timed_out']} disagree with the "
             f"replies ({shed}, {timeouts})")
    cache = engine.cache.stats()
    left = [sid for sid in engine.cache.session_ids() if sid not in kept
            and (not sid.startswith(serve.PREFIX_SID_NAMESPACE)
                 or sid.startswith(serve.PREFIX_SID_NAMESPACE + "timed-out/"))]
    tiers = engine.tiers.stats()["entries"]
    if cache["pinned"] or left or any(tiers.values()):
        fail(f"{label}: after the burst pinned {cache['pinned']}, sessions "
             f"{left}, tier entries {tiers}")
    ttft.sort()
    print(f"  {len(results)} requests in {wall:.3f} s: "
          f"{len(ttft)} completed ({done_tokens} tokens, "
          f"{done_tokens / wall:.1f} tokens/s; TTFT ms p50 "
          f"{percentile(ttft, 50):.3f} p99 {percentile(ttft, 99):.3f}), "
          f"shed {shed} (Retry-After header {min(h for h, _ in retry)}–"
          f"{max(h for h, _ in retry)} s, hint "
          f"{min(s for _, s in retry):.3f}–{max(s for _, s in retry):.3f} s),"
          f" {timeouts} timed out ({partial} with partial tokens, each a "
          f"prefix of the CPU plain generate); every slot free but the "
          f"{len(kept)} completed kept sessions', no tier copy left; "
          f"launches {counted.launches}; {card_line()}",
          flush=True)
    return counted.launches


def strict_json(text, label):
    def refuse(c):
        fail(f"{label}: the report holds {c}: not strict JSON")
    return json.loads(text, parse_constant=refuse)


def loadgen_phase(torch, device):
    print("== phase 20b: `serve --loadgen` at config 1, closed-loop and "
          "--idle-churn", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loadgen_")
    atexit.register(shutil.rmtree, tmp, True)
    for mode, extra in (("closed", ["--compare", ""]),
                        ("idle-churn", ["--idle-churn", "--num-slots", "4",
                                        "--max-active", "4"])):
        path = os.path.join(tmp, f"{mode}.json")
        cmd = [sys.executable, "-m", "lstm_tensorspark_torch", "serve",
               "--loadgen", *CONFIG1_FLAGS, *LOADGEN_FLAGS, *extra,
               "--json", path, "--device", device.type]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except subprocess.TimeoutExpired:
            fail(f"phase 20b {mode}: serve --loadgen ran past 300 s")
        if proc.returncode != 0:
            fail(f"phase 20b {mode}: rc {proc.returncode}: "
                 f"{(proc.stdout + proc.stderr)[-3000:]}")
        with open(path) as f:
            report = strict_json(f.read(), f"phase 20b {mode}")
        if report["failed"] or report["requests"] != (
                report["completed"] + report["rejected"] + report["failed"]
                + report.get("timeouts", 0)):
            fail(f"phase 20b {mode}: the counts do not add up: {report}")
        if mode == "closed":
            classes = report.get("classes")
            if not classes or any(
                    c["completed"] + c["shed"] + c["timeouts"] != 16
                    for c in classes.values()):
                fail(f"phase 20b: per-class counts {classes}")
        print(f"  {mode}: {report['completed']} of {report['requests']} "
              f"requests in {time.perf_counter() - t0:.1f} s (the process); "
              f"{report['tokens_per_sec']} tokens/s; TTFT ms p50 "
              f"{report['p50_ttft_ms']} p99 {report['p99_ttft_ms']}; gap ms "
              f"p50 {report['p50_itl_ms']} p99 {report['p99_itl_ms']} max "
              f"{report['max_itl_ms']}; kernel launches of the process "
              f"{report['engine']['launch_counts']}; {card_line()}",
              flush=True)


def metrics_phase(torch, tlm, tgen, serve, device):
    print("== phase 20c: `serve --http` with default flags: GET /metrics "
          "after a burst", flush=True)
    from lstm_tensorspark_torch.obs import parse_exposition

    import numpy as np

    cfg, params_cpu, _ = make_model(torch, tlm, 0, device="cpu", **CONFIG1)
    rng = np.random.RandomState(41)
    prompts = [rng.randint(0, cfg.vocab_size,
                           size=int(rng.randint(3, 30))).tolist()
               for _ in range(8)]
    refs = [cpu_generate(tgen, params_cpu, cfg, p, 16) for p in prompts]
    cmd = [sys.executable, "-m", "lstm_tensorspark_torch", "serve", "--http",
           "--port", "0", *CONFIG1_FLAGS, "--device", device.type]
    proc, port, boot = boot_serve(cmd, "phase 20c")
    try:
        before = get_stats(port)["engine"]["launch_counts"]
        out = post_all(port, [{"prompt": p, "max_new_tokens": 16,
                               "greedy": True} for p in prompts])
        stats = get_stats(port)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            ctype, text = resp.getheader("Content-Type"), resp.read().decode()
        finally:
            conn.close()
    finally:
        proc.send_signal(2)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for i, r in enumerate(out):
        if r is None or r[0] != 200 or r[1]["tokens"] != refs[i]:
            fail(f"phase 20c: request {i}: {r} != the CPU plain generate "
                 f"{refs[i]}")
    try:
        fams = parse_exposition(text)
    except ValueError as e:
        fail(f"phase 20c: GET /metrics is no valid exposition: {e}")

    def sample(fam, name, labels):
        got = [v for n, lab, v in fams[fam]["samples"]
               if n == name and lab == labels]
        return got[0] if len(got) == 1 else None

    ok = sample("serve_requests_total", "serve_requests_total",
                {"outcome": "completed", "replica": "0"})
    ttft_n = sample("serve_ttft_seconds", "serve_ttft_seconds_count",
                    {"replica": "0"})
    if not ctype.startswith("text/plain") or ok != len(prompts) or (
            ttft_n != len(prompts)):
        fail(f"phase 20c: {ctype}; serve_requests_total completed {ok}, "
             f"TTFT count {ttft_n}, expected {len(prompts)}")
    launches = {k: v - before.get(k, 0)
                for k, v in stats["engine"]["launch_counts"].items()
                if v - before.get(k, 0)}
    print(f"  booted in {boot:.1f} s; {len(prompts)} requests identical to "
          f"the CPU plain generate; /metrics: {len(fams)} families, "
          f"{len(text)} bytes, completed {ok:.0f}, TTFT count {ttft_n:.0f} "
          f"(server p50 {stats['metrics']['serve_ttft_seconds']['p50']} s); "
          f"launches {launches}", flush=True)
    return launches


def phase20(torch, tlm, tgen, serve, device):
    """Phase 20 (a-c); returns the launches of its in-process and
    ``serve --http`` runs by counter, and fails unless each of
    LOAD_KERNELS launched."""
    t0 = time.perf_counter()
    launches = {}
    for got in (timed(admission_phase, torch, tlm, tgen, serve, device,
                      "float32"),
                timed(admission_phase, torch, tlm, tgen, serve, device,
                      "bfloat16"),
                timed(metrics_phase, torch, tlm, tgen, serve, device)):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    timed(loadgen_phase, torch, device)
    missing = [k for k in LOAD_KERNELS if not launches.get(k)]
    if missing:
        fail(f"phase 20: {missing} launched no time ({launches})")
    print(f"  phase 20: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}", flush=True)
    return launches


def timed(fn, *args):
    """``fn(*args)``, printing the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA card")
    try:
        from lstm_tensorspark_torch import cli, configure_precision, kernels
        from lstm_tensorspark_torch import serve
        from lstm_tensorspark_torch.models import generate as tgen
        from lstm_tensorspark_torch.models import lstm_lm as tlm
        from lstm_tensorspark_torch.ops import cuda_decode as cd
        from lstm_tensorspark_torch.ops import cuda_lstm as cl
        from lstm_tensorspark_torch.ops import cuda_lstmx as cx
        from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
        from lstm_tensorspark_torch.ops import cuda_spec as cs
        from lstm_tensorspark_torch.train.distill import draft_config
    except ImportError as e:
        fail(f"the port is not importable (run from the repo root): {e}")

    print("== phase 1: versions and card", flush=True)
    card = card_line()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}", flush=True)
    print(f"  nvidia-smi: {card}", flush=True)
    configure_precision()
    device = torch.device("cuda", 0)

    # the CPU references of phases 8 and 16 start now, beside the build
    host = HostRuns()
    atexit.register(host.stop)
    for name, flags in host_references():
        host.start(name, flags)
    print("== phase 2: build the CUDA kernels", flush=True)
    sources = kernels.SOURCES
    secs = kernels.build(sources)
    print(f"  {', '.join(n + '.cu' for n in sources)} built in {secs:.2f} s",
          flush=True)
    for name in sources:
        log = kernels.library_path(name).with_name(
            kernels.library_path(name).name + ".log")
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}", flush=True)

    max_err, timings = timed(kernel_phase, torch, tlm, tgen, cd, device)
    launches, tokens = timed(serve_phase, torch, tlm, tgen, cd, serve,
                             device)
    lstm_timings = timed(lstm_kernel_phase, torch, cl, device)
    bf16_timings = timed(bf16_kernel_phase, torch, cl, ct, device,
                         "resident")
    train_launches = timed(train_phase, torch, cli, cl, device)
    lstmx_timings = timed(lstmx_kernel_phase, torch, cx, device)
    bf16x_timings = timed(bf16_residentx_phase, torch, cx, device)
    config2_launches = timed(config2_phase, torch, cli, cl, cx, ct, device,
                             host)
    tiled_timings = timed(tiled_kernel_phase, torch, cl, ct, device)
    bf16_timings.update(timed(bf16_kernel_phase, torch, cl, ct, device,
                              "tiled"))
    config5_launches = timed(config5_phase, torch, cli, cl, cx, ct, device)
    spec_err, spec_timings = timed(spec_kernel_phase, torch, tlm, tgen, cd,
                                   cs, draft_config, device)
    spec_launches = timed(spec_serve_phase, torch, tlm, tgen, cd, cs, cl,
                          serve, draft_config, device)
    timed(config3_phase, torch, tlm, tgen, cd, serve, device)
    # the whole smoke leaves out the timing turns PERF.md §5 already has
    # readings of (the flags that run these phases alone time them all)
    timed(train_calls_phase, torch, cli, cl, cx, ct, device, False)
    bf16_launches = timed(bf16_train_phase, torch, cli, cl, cx, ct, device,
                          False)
    bf16x_launches = timed(bf16x_train_phase, torch, cli, cl, cx, ct, device,
                           host, False)
    for name, flags in config4_references():  # beside phases 17 and 18a
        host.start(name, flags)
    serve_rows = timed(phase17, torch, cli, tlm, tgen, cd, cs, cl, ct, serve,
                       draft_config, device)
    config4_launches = phase18(torch, cli, cl, cx, ct, device, host)
    session_launches = phase19(torch, tlm, tgen, cl, ct, serve, draft_config,
                               device)
    load_launches = phase20(torch, tlm, tgen, serve, device)
    for k, v in config4_launches.items():
        if k in bf16_launches:
            bf16_launches[k] += v
        else:
            train_launches[k.split("_")[1]] += v

    main_path = timings["config1"]
    lstm_rows = [{
        "name": f"lstm_{kind}",
        "route": "cuda",
        "source": f"lstm_tensorspark_torch/csrc/lstm_{kind}.cu",
        "replaces": ("lstm_tensorspark_tpu/ops/pallas_lstm.py:528"
                     if kind == "fwd"
                     else "lstm_tensorspark_tpu/ops/pallas_lstm.py:597"),
        "launches": train_launches[kind],
        "max_abs_err": lstm_timings[kind]["max_err"],
        "ms": lstm_timings[kind]["kernel_ms"],
        "plain_ms": lstm_timings[kind]["plain_ms"],
        "bound_ms": lstm_timings[kind]["bound_ms"],
        "bound_by": lstm_timings[kind]["bound_by"],
        "library_ms": lstm_timings[kind]["library_ms"],
    } for kind in ("fwd", "bwd")]
    replaces = {
        "lstmx_fwd": "lstm_tensorspark_tpu/ops/pallas_lstm.py:383",
        "lstmx_bwd": "lstm_tensorspark_tpu/ops/pallas_lstm.py:444",
        "bilstm_fwd": "lstm_tensorspark_tpu/ops/pallas_bilstm.py:108",
        "bilstm_bwd": "lstm_tensorspark_tpu/ops/pallas_bilstm.py:178",
    }
    lstmx_rows = [{
        "name": role,
        "route": "cuda",
        "source": ("lstm_tensorspark_torch/csrc/lstmx_"
                   f"{role.split('_')[1]}.cu"),
        "replaces": replaces[role],
        "launches": config2_launches[role],
        "max_abs_err": lstmx_timings[role]["max_err"],
        "ms": lstmx_timings[role]["kernel_ms"],
        "plain_ms": lstmx_timings[role]["plain_ms"],
        "bound_ms": lstmx_timings[role]["bound_ms"],
        "bound_by": lstmx_timings[role]["bound_by"],
        "library_ms": lstmx_timings[role]["library_ms"],
    } for role in replaces]
    tiled_rows = [{
        "name": f"lstm_tiled_{kind}",
        "route": "cuda",
        "source": f"lstm_tensorspark_torch/csrc/lstm_tiled_{kind}.cu",
        "replaces": ("lstm_tensorspark_tpu/ops/pallas_lstm.py:670"
                     if kind == "fwd"
                     else "lstm_tensorspark_tpu/ops/pallas_lstm.py:744"),
        "launches": config5_launches[kind],
        "max_abs_err": tiled_timings[kind]["max_err"],
        "ms": tiled_timings[kind]["kernel_ms"],
        "plain_ms": tiled_timings[kind]["plain_ms"],
        "bound_ms": tiled_timings[kind]["bound_ms"],
        "bound_by": tiled_timings[kind]["bound_by"],
        "library_ms": tiled_timings[kind]["library_ms"],
    } for kind in ("fwd", "bwd")]
    bf16_rows = [bf16_row(name, bf16_timings[name], bf16_launches[name])
                 for name in bf16_launches]
    bf16_rows += [bf16_row(name, bf16x_timings[name], bf16x_launches[name])
                  for name in BF16X_ROWS]
    rows = [{
        "name": "decode_window",
        "route": "cuda",
        "source": "lstm_tensorspark_torch/csrc/decode_window.cu",
        "replaces": "lstm_tensorspark_tpu/ops/pallas_decode.py:109",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
    }, {
        "name": "spec_window",
        "route": "cuda",
        "source": "lstm_tensorspark_torch/csrc/spec_window.cu",
        "replaces": "lstm_tensorspark_tpu/ops/pallas_decode.py:367",
        "launches": spec_launches,
        "max_abs_err": spec_err,
        "ms": spec_timings["config1"]["kernel_ms"],
        "plain_ms": spec_timings["config1"]["plain_ms"],
        "bound_ms": spec_timings["config1"]["bound_ms"],
        "bound_by": spec_timings["config1"]["bound_by"],
        "library_ms": None,
    }] + lstm_rows + lstmx_rows + tiled_rows + bf16_rows + serve_rows
    # phases 19 and 20 drive the serve path again: their launches join the
    # rows
    by_name = {r["name"]: r for r in rows}
    for phase, got in (("19", session_launches), ("20", load_launches)):
        stray = set(got) - set(by_name)
        if stray:
            fail(f"phase {phase} launched kernels the report has no row of: "
                 f"{stray}")
        for name, n in got.items():
            by_name[name]["launches"] += n
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def resident_pair(label: str) -> int:
    """The resident pair of the checkout in the working directory at config
    1 (B=64, T=64, H=128, no mask): the forward with residuals and the
    backward from them, CUDA-event ms over 100 calls each, and config 1's
    training (steps/s, the device's busy ms a step), on one line tagged
    ``label`` with the backward's plan."""
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this timing needs an NVIDIA card")
    from lstm_tensorspark_torch import configure_precision
    from lstm_tensorspark_torch.ops import cuda_lstm as cl

    configure_precision()
    B, T, H = LSTM_CONFIG1["B"], LSTM_CONFIG1["T"], LSTM_CONFIG1["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=torch.device("cuda", 0))
    _, _, _, z, cs = cl.lstm_forward(*inputs, save_residuals=True)
    fwd = time_ms(torch, lambda: cl.lstm_forward(
        *inputs, save_residuals=True), 100)
    bwd = time_ms(torch, lambda: cl.lstm_backward(
        z, inputs[3], cs, dys, inputs[1], dhT, dcT), 100)
    # config 1's training: steps/s over 300 steps (host clock, synchronised)
    # and the device's busy ms a step over 20 under torch.profiler
    from lstm_tensorspark_torch import cli

    run = config1_steps(cli, 300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    sps = 300 / (time.perf_counter() - t0)
    prof = device_profile(torch, config1_steps(cli))
    busy = "not measured" if prof is None else f"{prof[0] / 20:.4f} ms"
    idle = "" if prof is None else f", idle share {1 - prof[0] / prof[1]:.3f}"
    print(f"resident pair of {label} ({os.getcwd()}) at B={B} T={T} H={H}: "
          f"forward {fwd:.4f} ms, backward {bwd:.4f} ms "
          f"({1e3 * bwd / T:.2f} us a step; {cl.plan('bwd', B, H)}); config "
          f"1 training {sps:.1f} steps/s, device busy {busy} a step{idle}; "
          f"{card_line()}", flush=True)
    return 0


def tiled_pair(label: str) -> int:
    """The tiled pair of the checkout in the working directory at config
    5's shard: the forward with residuals and the backward, CUDA-event ms
    over 20 calls each, on one line tagged ``label``."""
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this timing needs an NVIDIA card")
    from lstm_tensorspark_torch import configure_precision
    from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct

    configure_precision()
    B, T, H = LSTM_CONFIG5["B"], LSTM_CONFIG5["T"], LSTM_CONFIG5["H"]
    inputs, (dys, dhT, dcT) = lstm_inputs(torch, B, T, H, False, seed=1,
                                          device=torch.device("cuda", 0))
    _, _, _, z, cs = ct.lstm_tiled_forward(*inputs, save_residuals=True)
    fwd = time_ms(torch, lambda: ct.lstm_tiled_forward(
        *inputs, save_residuals=True), 20)
    bwd = time_ms(torch, lambda: ct.lstm_tiled_backward(
        z, inputs[3], cs, dys, inputs[1], dhT, dcT), 20)
    print(f"tiled pair of {label} ({os.getcwd()}) at B={B} T={T} H={H}: "
          f"forward {fwd:.4f} ms, backward {bwd:.4f} ms; {card_line()}",
          flush=True)
    return 0


def residentx_fwd(label: str) -> int:
    """The residentx forward of the checkout in the working directory at
    config 2, masked with the IMDB stand-in's lengths: two directions with
    cs (the stacked bi-LSTM layer of a training step) and one direction
    without (the forward under ``--remat-chunk 50``), CUDA-event ms over
    20 calls each, on one line tagged ``label``; and beside them the
    residentx backward where phase 8 launches it (config 2's two
    directions, the LM's one at T=256), from the same checkout."""
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this timing needs an NVIDIA card")
    from lstm_tensorspark_torch import configure_precision
    from lstm_tensorspark_torch.ops import cuda_lstmx as cx

    configure_precision()
    B, T, D, H = (CONFIG2[k] for k in ("B", "T", "D", "H"))
    lens = imdb_lengths(B, T)
    dev = torch.device("cuda", 0)
    ms = {}
    for nd, save_c in ((2, True), (1, False)):
        inputs, _ = lstmx_inputs(torch, B, T, D, H, nd, lens, seed=7,
                                 device=dev)
        ms[nd] = time_ms(torch, lambda: cx.lstmx_forward(
            *inputs, save_c=save_c), 20)
    bwd = {}
    for name, (Bb, Tb, Db, Hb), nd, lb in (
            ("config2", (B, T, D, H), 2, lens),
            ("lm256", (LM256["B"], LM256["T"], LM256["D"], LM256["H"]), 1,
             None)):
        inputs, (dys, dhT, dcT) = lstmx_inputs(torch, Bb, Tb, Db, Hb, nd, lb,
                                               seed=7, device=dev)
        xs, W, b, U, h0, c0, mask = inputs
        ys, _, _, cs = cx.lstmx_forward_reference(*inputs, save_c=True)
        bwd[name] = time_ms(torch, lambda: cx.lstmx_backward(
            xs, ys, h0, cs, c0, dys, W, b, U, dhT, dcT, mask), 20)
    print(f"residentx forward of {label} ({os.getcwd()}) at config 2 B={B} "
          f"T={T} D={D} H={H}, masked: two directions with cs "
          f"{ms[2]:.4f} ms, one without {ms[1]:.4f} ms; backward two "
          f"directions {bwd['config2']:.4f} ms, one at the LM's T=256 "
          f"{bwd['lm256']:.4f} ms; {card_line()}", flush=True)
    return 0


def _checkout(label: str):
    """torch and the port of the checkout in the working directory, on the
    card (for the parent/change turns)."""
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: this timing needs an NVIDIA card")
    from lstm_tensorspark_torch import configure_precision

    configure_precision()
    return torch, torch.device("cuda", 0)


def windows(label: str) -> int:
    """The decode and spec windows of the checkout in the working directory
    at config 1 (decode B=16 and B=1, K=8; spec B=16 and B=1, k_draft=4,
    the draft_config draft) and at config 3's width (B=4, K=4 and
    k_draft=4, its H=162 draft), greedy, every row live: CUDA-event ms
    over 50 calls and device ms per launch under torch.profiler over 20,
    on one line tagged ``label``."""
    torch, dev = _checkout(label)
    from lstm_tensorspark_torch.models import generate as tgen
    from lstm_tensorspark_torch.models import lstm_lm as tlm
    from lstm_tensorspark_torch.ops import cuda_decode as cd
    from lstm_tensorspark_torch.ops import cuda_spec as cs
    from lstm_tensorspark_torch.train.distill import draft_config

    out = []
    for name, spec, B, K in (("config1", CONFIG1, 16, 8),
                             ("config1", CONFIG1, 1, 8),
                             ("config3", CONFIG3, 4, 4)):
        cfg, _, params = make_model(torch, tlm, 1, device=dev, **spec)
        w = weights_of(cd, tgen, params, cfg)
        inputs = window_inputs(torch, cd, w, cfg, B, K, True, seed=7,
                               device=dev, edge_rows=False)
        fn = lambda: cd.decode_window(w, *inputs, window=K, temperature=1.0,
                                      greedy=True)
        dms = profiled_ms(torch, fn, "decode_window", 20)
        dev_ms = "not recorded" if dms is None else f"{dms:.4f}"
        out.append(f"decode {name} B={B} K={K} {time_ms(torch, fn, 50):.4f} "
                   f"ms (device {dev_ms})")
    for name, spec, B, K in (("config1", CONFIG1, 16, 4),
                             ("config1", CONFIG1, 1, 4),
                             ("config3", CONFIG3, 4, 4)):
        cfg = tlm.LMConfig(vocab_size=spec["vocab"], hidden_size=spec["hidden"],
                           num_layers=spec["layers"])
        params = tlm.params_to(tlm.init_lm(torch.Generator().manual_seed(1),
                                           cfg), dev)
        dcfg = draft_config(cfg)
        dparams = tlm.params_to(tlm.init_lm(
            torch.Generator().manual_seed(2), dcfg), dev)
        tw, dw = weights_of(cd, tgen, params, cfg), weights_of(cd, tgen,
                                                               dparams, dcfg)
        inputs = spec_inputs(torch, cfg, dcfg, B, K, 7, dev, False)
        inputs[5].fill_(1)
        inputs[6].fill_(K + 4)
        fn = lambda: cs.spec_window(tw, dw, *inputs, k_draft=K)
        dms = profiled_ms(torch, fn, "spec_window", 20)
        dev_ms = "not recorded" if dms is None else f"{dms:.4f}"
        out.append(f"spec {name} B={B} k_draft={K} "
                   f"{time_ms(torch, fn, 50):.4f} ms (device {dev_ms})")
    print(f"windows of {label} ({os.getcwd()}): " + "; ".join(out)
          + f"; {card_line()}", flush=True)
    return 0


def config3_burst_turn(label: str) -> int:
    """Phase 13's config-3 burst from the checkout in the working
    directory, on one line tagged ``label``."""
    torch, dev = _checkout(label)
    from lstm_tensorspark_torch import serve
    from lstm_tensorspark_torch.models import generate as tgen
    from lstm_tensorspark_torch.models import lstm_lm as tlm
    from lstm_tensorspark_torch.ops import cuda_decode as cd

    r = config3_burst(torch, tlm, tgen, cd, serve, dev)
    print(f"config 3 burst of {label} ({os.getcwd()}): {burst_line(r)}; "
          f"{card_line()}", flush=True)
    return 0


def train_calls(label: str) -> int:
    """Phase 14 alone, from the checkout in the working directory (its
    kernels built first), tagged ``label``."""
    torch, dev = _checkout(label)
    from lstm_tensorspark_torch import cli, kernels
    from lstm_tensorspark_torch.ops import cuda_lstm as cl
    from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
    from lstm_tensorspark_torch.ops import cuda_lstmx as cx

    print(f"phase 14 of {label} ({os.getcwd()}); kernels built in "
          f"{kernels.build(kernels.SOURCES):.1f} s", flush=True)
    train_calls_phase(torch, cli, cl, cx, ct, dev)
    return 0


def bf16(label: str) -> int:
    """The bf16 work alone (the bf16 parts of phases 5, 7 and 9, phases 15
    and 16), from the checkout in the working directory, tagged ``label``;
    ``label`` ``kernels`` skips phases 15 and 16, ``residentx`` runs phase
    7's bf16 part and phase 16 alone, ``windows`` phase 17a alone and
    ``serve`` phase 17."""
    torch, dev = _checkout(label)
    from lstm_tensorspark_torch import cli, kernels
    from lstm_tensorspark_torch.ops import cuda_lstm as cl
    from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
    from lstm_tensorspark_torch.ops import cuda_lstmx as cx

    print(f"bf16 phases of {label} ({os.getcwd()}; {card_line()}); kernels "
          f"built in {kernels.build(kernels.SOURCES):.1f} s", flush=True)
    if label in ("windows", "serve"):
        from lstm_tensorspark_torch import serve
        from lstm_tensorspark_torch.models import generate as tgen
        from lstm_tensorspark_torch.models import lstm_lm as tlm
        from lstm_tensorspark_torch.ops import cuda_decode as cd
        from lstm_tensorspark_torch.ops import cuda_spec as cs
        from lstm_tensorspark_torch.train.distill import draft_config

        for name in ("decode_window", "decode_window_bf16", "spec_window",
                     "spec_window_bf16", "lstm_fwd", "lstm_tiled_fwd"):
            print(f"  ptxas {name}: {ptxas_registers(kernels, name)}",
                  flush=True)
        if label == "windows":
            timed(bf16_windows_phase, torch, tlm, tgen, cd, cs, cl, ct,
                  draft_config, dev)
        else:
            print(json.dumps(timed(phase17, torch, cli, tlm, tgen, cd, cs,
                                   cl, ct, serve, draft_config, dev)),
                  flush=True)
        return 0
    host = HostRuns()
    atexit.register(host.stop)
    if label != "kernels":
        host.start(*host_references()[1])
    rows, t = [], {}
    if label != "residentx":
        t = timed(bf16_kernel_phase, torch, cl, ct, dev, "resident")
        t.update(timed(bf16_kernel_phase, torch, cl, ct, dev, "tiled"))
    tx = timed(bf16_residentx_phase, torch, cx, dev)
    if label != "kernels":
        if label != "residentx":
            launches = timed(bf16_train_phase, torch, cli, cl, cx, ct, dev)
            rows += [bf16_row(n, t[n], launches[n]) for n in launches]
        lx = timed(bf16x_train_phase, torch, cli, cl, cx, ct, dev, host)
        rows += [bf16_row(n, tx[n], lx[n]) for n in BF16X_ROWS]
        print(json.dumps(rows), flush=True)
    return 0


def forecast() -> int:
    """Phase 18 alone, from the checkout in the working directory (the
    resident pair built first); prints the main runs' launches."""
    torch, dev = _checkout("forecast")
    from lstm_tensorspark_torch import cli, kernels
    from lstm_tensorspark_torch.ops import cuda_lstm as cl
    from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
    from lstm_tensorspark_torch.ops import cuda_lstmx as cx

    host = HostRuns()
    atexit.register(host.stop)
    for name, flags in config4_references():
        host.start(name, flags)
    print(f"phase 18 ({os.getcwd()}; {card_line()}); resident pair built "
          f"in {kernels.build(['lstm_fwd', 'lstm_bwd']):.1f} s", flush=True)
    print(json.dumps(phase18(torch, cli, cl, cx, ct, dev, host)), flush=True)
    return 0


def sessions() -> int:
    """Phase 19 alone, from the checkout in the working directory (the
    serve path's kernels built first); prints its launches."""
    torch, dev = _checkout("sessions")
    from lstm_tensorspark_torch import kernels, serve
    from lstm_tensorspark_torch.models import generate as tgen
    from lstm_tensorspark_torch.models import lstm_lm as tlm
    from lstm_tensorspark_torch.ops import cuda_lstm as cl
    from lstm_tensorspark_torch.ops import cuda_lstm_tiled as ct
    from lstm_tensorspark_torch.train.distill import draft_config

    built = kernels.build(["decode_window", "decode_window_bf16",
                           "spec_window", "lstm_fwd", "lstm_tiled_fwd"])
    print(f"phase 19 ({os.getcwd()}; {card_line()}); serve kernels built "
          f"in {built:.1f} s", flush=True)
    print(json.dumps(phase19(torch, tlm, tgen, cl, ct, serve, draft_config,
                             dev)), flush=True)
    return 0


def loadgen() -> int:
    """Phase 20 alone, from the checkout in the working directory (the
    serve path's kernels built first); prints its launches."""
    torch, dev = _checkout("loadgen")
    from lstm_tensorspark_torch import kernels, serve
    from lstm_tensorspark_torch.models import generate as tgen
    from lstm_tensorspark_torch.models import lstm_lm as tlm

    built = kernels.build(["decode_window", "decode_window_bf16",
                           "lstm_fwd"])
    print(f"phase 20 ({os.getcwd()}; {card_line()}); serve kernels built "
          f"in {built:.1f} s", flush=True)
    print(json.dumps(phase20(torch, tlm, tgen, serve, dev)), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--loadgen"]:
        sys.exit(loadgen())
    if sys.argv[1:] == ["--forecast"]:
        sys.exit(forecast())
    if sys.argv[1:] == ["--sessions"]:
        sys.exit(sessions())
    for flag, fn in (("--train-calls", train_calls),
                     ("--bf16", bf16),
                     ("--windows", windows),
                     ("--config3-burst", config3_burst_turn),
                     ("--resident-pair", resident_pair),
                     ("--tiled-pair", tiled_pair),
                     ("--residentx-fwd", residentx_fwd)):
        if sys.argv[1:2] == [flag] and len(sys.argv) == 3:
            sys.exit(fn(sys.argv[2]))
    sys.exit(main())
