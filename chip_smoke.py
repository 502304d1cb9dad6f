#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Phases:
  1. build the CUDA kernels from src/repro_torch/csrc/ (one nvcc each, in
     parallel) and print the build seconds;
  2. print the card's name and power limit (nvidia-smi);
  3. hold every kernel against its plain PyTorch version on the card: all
     three epilogue kinds, weighted and unweighted, shapes that do not divide
     the tiles, and the exact bucket and score shapes of phases 4, 5 and 9
     (the field bucket with per-node prefix weights, a ragged slice), and
     that a second Newton call is bitwise equal; time kernel, plain version
     and a library yardstick with CUDA events, and the Newton and score
     kernels' device time under torch.profiler (back-to-back events read
     the host's pace where a call's kernels take a few microseconds);
  4. paper scale (Fig. 4 of the paper at p = 100, n = 4000): Ising on a
     Euclidean and a scale-free graph, Potts (q = 3) on the Euclidean graph;
     kernel fits against plain fits, and the diagonal combiner's error to the
     truth shrinking from n = 1000 to n = 4000;
  5. deployment scale: a 64 x 64 sensor grid (p = 4096) at n = 16384, cold
     and warm fit wall seconds (the median and range of five more warm
     fits), and the device's busy share of a profiled warm fit;
  6. launch counts: the Newton kernel ran at least once per bucket per Newton
     iteration, the score kernel once per fit, and no plain version saw a
     CUDA tensor during the kernel-path fits;
  7. the flash-attention, masked-logits and Gram kernels against their plain
     versions on the card: ragged shapes (s, n, p, d that divide no tile),
     every head grouping and window kind, both dtypes of the attention
     kernel, the masked logits for C = 1 .. 5 and on a dense mask, the Gram
     kernel's bitwise symmetry, second calls bitwise equal, and the shapes of
     the serving path and of kernels_bench; kernel, plain and library times
     with CUDA events (the masked logits also beside torch.sparse.mm);
     conditional_logits_op and gram_op driven once through the kernels;
  8. Llama-3.2-3B at full width and depth (weights drawn on the card from a
     seeded generator): generate with b = 4, a 2048-token prompt and 32 new
     tokens, then a sliding-window request (window 4096, b = 1, an
     8192-token prompt, 16 new tokens); prefill then teacher-forced decode
     against the full forward, the window cache's length, greedy
     determinism, 28 flash-attention launches per prefill, and the device's
     busy share of one profiled prefill;
  9. streaming and joint estimation on the 64 x 64 grid: a stream from a
     2048-row buffer takes 8 chunks of 2048 rows with a refit each (three
     doublings) and must equal one fit of the 16384 rows within 1e-5; a
     windowed refit (window 4096, half the nodes at 8192 rows and half at
     16384) through the kernel against the plain refit; joint ADMM from the
     diagonal one-step (30 rounds, 15 Newton iterations) against the plain
     joint, with its primal residual falling and the device's busy share of
     one profiled joint; the simulator, 16 rounds of 256 arrivals per node
     on a perfect network (equal to the global diagonal combine within
     1e-5) and streaming ADMM on a lossy one (its error falling); the Newton
     kernel launched in every refit and prox round, the score kernel in
     every score norm, and no plain version on a CUDA tensor;
 10. structure learning (session.select): at the reference's structure-bench
     size (benchmarks/structure_bench.py: a 5 x 6 grid, couplings +-0.5
     Ising and +-0.3 Gaussian, n = 2000, policy full, the default spec) F1
     >= 0.95 cold and on fresh same-shape data, the kernel select against
     the plain select (same support and selected lambda, EBIC within 1e-5),
     the Newton kernel against its plain version at the candidate graph's
     bucket, no library built by the second call; at the deployment scale
     (the 64 x 64 grid's 16384 rows, Ising, policy knn with k = 8) the
     Newton kernel against its plain version (and timed beside it and
     torch.bmm) at each bucket of the candidate graph, screened as select
     screens it, then cold and warm wall seconds at the default depth,
     then, with the path cut to FIELD_SELECT_CUTS (printed on the lines),
     the device's busy share of one profiled select, the bucket design
     rebuild's share of its device time, and the kernel select against
     the plain select (same support and selected lambda, EBIC within
     1e-5); every Newton iteration of the dense fit and of every prox
     round a Newton-kernel launch, and no plain version on a CUDA tensor;
 11. the paper's experiments from the port's own samplers
     (repro_torch.core): the sampler law on the card (exact_sample,
     sequential and chromatic gibbs_sample, gibbs_sample_family for every
     family; 65536 rows from 256 chains on a 3 x 3 grid, held to the exact
     moments at the conformance tolerances); Fig. 2's exact oracles on a
     12-node star (exact_locals, the four schemes', the joint MPLE's and
     the MLE's variance, on the card against the CPU within 1e-10, none
     below the MLE's) and local fits of 4000 exact draws, kernel against
     plain; Fig. 4 at paper size (100 nodes, n = 250, 1000, 4000,
     gibbs_sample "auto", fit_all_local through the Newton kernel, the four
     combiners, fit_mple with 25 Newton iterations; replicates cut to 2
     models x 2 sets): finite MSEs, the diagonal MSE falling with n, and
     the score kernel's pseudo-score at fit_mple's estimate stationary;
     chromatic draws on the 64 x 64 grid at n = 4096 and 16384 (seconds,
     the busy share of a profiled draw) and their fits, kernel against
     plain and the diagonal error falling; the Newton kernel held against
     its plain version at every bucket shape that phase sends and no
     earlier phase checked, and the launch counts of phase 6;
 12. parameter drift, durable stream checkpoints and a family without a
     fused-kernel epilogue: the hostile star of tests/stream/
     test_checkpoint.py (crash, Byzantine, replay and a drift at round 7;
     save_stream at round 6, restore_stream into a fresh simulator, rounds
     7-12 equal within 1e-10 with equal network counters; two same-seed
     runs bitwise equal; one-step and ADMM); a Gaussian MRF on the 64 x 64
     grid (16384 exact rows, window 2048, 256 arrivals per node per round,
     16 rounds, drift at round 8 at a scale that keeps I - T positive
     definite): the rows fed before the change-point unchanged, the truth
     moved at free coordinates only, the re-drawn tail at the drifted
     exact moments, a Newton launch in every round and a score launch in
     every recorded round, and the plain versions' trajectory within 1e-4;
     an Ising family registered with no epilogue fitted on phase 4's
     Euclidean rows and the field rows against the registered Ising's
     kernel fit (theta 1e-4, score norm 1e-4 relative, no Newton or score
     launch of its own), both walls printed;
 13. the seed score entry points and telemetry: every cl_score* entry,
     score_stats_op and family_score_stats for Ising, Gaussian and Potts
     (q = 3) against the plain versions at the reference's conformance
     shapes (max abs within PRECISION_TOLERANCES["float32"]), the paper
     shape and the field grid's zero-padded buffer (capacity 16384, 12288
     live rows; GATE_ELEM / GATE_STATS), one score launch per call and no
     plain version on a CUDA tensor; a warm field fit with telemetry on
     against off (outputs and launch counts bitwise equal, spans, cuda
     kernel tags on a fresh session's cold fit and none warm, the median
     of 5 warm fits each way); joint and select on the structure bench's
     5 x 6 grid with telemetry on against off; the hostile star of phase
     12 (one-step and ADMM) with a JSONL log whose replay equals the live
     network counters; a profile_dir trace naming the Newton and score
     kernels;
 14. the multi-tenant session server (repro_torch.serve): the serve bench
     at its full size (benchmarks/serve_bench.py, REPRO_BENCH_FULL=1: 32
     tenants over two plans on scale_free_graph(24, seed=0), 12 rounds of
     256 rows from synthetic_workload(seed=0) on the card, max_coalesce 8,
     a VirtualClock, round 0 the warm-up), coalesced and serial: no
     rejection, no library build when warm, coalesced throughput above
     serial, every coalesced ticket within GATE_COALESCE of the serial
     server's, fewer Newton launches coalesced, the server's counters
     reconciled with the tickets; then eight tenants of one plan on the
     64 x 64 grid (Ising, diagonal, capacity 2048): fit requests of 2048
     of phase 5's rows each, one coalesced group (a union bucket of k =
     32768, d = 5) against eight serial dispatches, cold and warm, the
     Newton kernel held against its plain version at the union bucket and
     timed there, and three stream rounds through the weighted kernel;
     coalesced gated where every owner's serial fit is settled (cond(H) <
     COND_LIMIT, a plain float64 Newton step below STEP_LIMIT), the
     Newton kernel held at every new bucket shape of the served runs,
     every served run one Newton launch per statistics call and no plain
     version on a CUDA tensor.
 15. training (repro_torch.train, optim, data): the flash-attention
     kernel under autograd (SwaFunction: the kernel forward, the plain
     version's recompute backward) against plain autograd at the training
     shape, gradients bitwise equal; the synchronous trainer on
     Llama-3.2-3B at full width and depth (6 steps, b = 2, s = 2048, remat
     on, SyntheticLM): nll falling, 2 x 28 kernel launches a step, step
     wall, tokens/s, peak memory and a profiled step's share in the
     recompute; the pod-consensus trainer (2 pods, h_steps 2, 2 rounds,
     full width, 8 layers) for uniform, diagonal, max and admm; the
     reduced config on the card against the CPU; a consensus run saved
     after round 1, restored bitwise and resumed, against the
     uninterrupted run.
 16. the attention families of the model zoo at full width (ZOO: qwen2-moe
     and minicpm3, phi3 and glm4 at full depth, chameleon cut to 16 and
     llama4-scout to 6 layers, weights drawn on the card one model at a
     time): the swa kernel against its plain version at each model's
     prefill shape (MLA's 40/40 heads at width 96 with V zero-padded,
     glm4's 16-way group), timed beside plain and SDPA; generate at
     phase 8's shape twice (one launch a layer, bitwise equal tokens),
     prefill seconds, decode ms a step and peak memory, teacher-forced
     decode against the full forward (the expert models also in
     float32), the experts' routing (the capacity path at prefill with
     its dropped share, dropless decode), llama4-scout's prefill with
     patch embeddings, each model's profiled prefill (busy share, the swa
     kernel's device time); the six reduced configs on the card against
     the CPU.
 17. bfloat16 operands of the score, cl_logits and gram kernels: every
     op through its entry on the card at the reference's conformance
     shapes, an odd p and a p that is not a multiple of 8 (the Gram's copy
     widths), p > 128 with phase 7's masks (the pre-pass and both walks)
     and the field shape; eta and r within one bfloat16 ulp of the plain
     version on the float32 upcasts rounded once, S (GATE_STATS) and G
     (GATE_GRAM) against it, all three against the bfloat16 plain version
     (PRECISION_TOLERANCES["bfloat16"]), bitwise the float32 kernel's on
     the upcasts (rounded), repeats bitwise, one launch a call; the
     non-finite cases of tests/test_torch_cuda.py in bfloat16; no upcast
     copy (torch.cuda.max_memory_allocated around a field call: outputs
     and scratch only); the field score and cl_logits, the Potts paper
     score and gram at n = 16384, d = 512 timed against their bounds and
     one bfloat16 PyTorch call; family_score_stats (the field grid and
     the paper's Potts graph), score_stats_op, conditional_logits_op and
     gram_op on bfloat16 tensors with the counts set to 0 just before
     and read just after, for the kernels line's bfloat16 rows.
 18. recurrentgemma-2b at full width and depth (26 layers: eight
     rec/rec/attn units and two remainder RG-LRU layers; bf16 weights
     drawn on the card): the swa kernel against its plain version at its
     two prefill shapes (width 256, 10/1 heads, window 2048), timed beside
     plain, SDPA with the band mask and the bound; generate at phase 8's
     shape twice (eight launches a prefill, bitwise equal tokens, no plain
     attention on a CUDA tensor) and at RG_LONG (an 8192-token prompt:
     the window bites in the kernel, the ring buffer wraps in decode);
     prefill seconds, decode ms a step, peak memory, the caches' ring and
     RG-LRU states; teacher-forced decode against the full forward
     (GATE_SERVE) at both shapes; a profiled prefill at each (busy share,
     the RG-LRU scan's share of device time, the swa kernel's device
     time); the reduced config on the card against the CPU.
 19. xlstm-1.3b at full width and depth (48 layers: six units of seven
     mLSTM and one sLSTM; d 2048, mLSTM width 4096 in 4 heads of 1024;
     bf16 weights drawn on the card): the mLSTM chunk scan against its
     chunk-1 recurrence on layer 0's inputs (b = 1, 1024 positions = 4
     chunks, float32, GATE_SCAN), timed beside its bound; generate at
     phase 8's shape twice (no swa launch, no plain attention on a CUDA
     tensor, bitwise equal tokens) and prefill + greedy decode steps at
     both requests, the long one XL_LONG (a 4096-token prompt, 16 chunks
     carried); prefill seconds, decode ms a step and peak memory beside
     the chunk scans', the sLSTM loop's and a decode step's bounds; the
     (C, n, m) and sLSTM states; prefill and teacher-forced decode against
     the full forward (the forward padded to a length the chunk divides):
     reported in bf16, gated in float32 over XL_F32_LAYERS layers
     (GATE_TF32); a profiled prefill at each request, the long one cut to
     XL_PROFILED tokens (busy share, the chunk scan's and the sLSTM
     position loop's shares of device time, no copy to the host); the
     reduced config on the card against the CPU.
 20. whisper-tiny at full width and depth (4 encoder and 4 decoder layers,
     d 384, 6 heads of 64, 1500 frames, vocab 51865 padded to 52096; bf16
     weights and frame embeddings drawn on the card): the swa kernel
     against its plain version at both prefill shapes (width 64, 6/6
     heads, no window; bf16 and float32), timed beside plain, SDPA and the
     bound at the 224-token prompt; generate at WH_REQUEST (b = 8, a
     224-token prompt, 224 new tokens) twice and at WH_FIRST (a 4-token
     prompt): bitwise equal tokens, one swa launch a decoder layer in the
     prefill and none in a decode step, no causal plain attention on a
     CUDA tensor, the non-causal plain calls (the encoder's and the
     cross-attention's materialised scores) counted; encode ms, prefill
     seconds, decode ms a step and peak memory beside their bounds;
     prefill and teacher-forced decode against one forward, bf16
     (GATE_SERVE) and float32 at full depth (GATE_TF32); a profiled
     prefill at each request (busy share, the encoder's and the non-causal
     attention's shares of device time, the swa kernel's device time), a
     profiled encoder and profiled decode steps (the cross-attention's
     share); the encoder and a cross-attention layer at full
     width in float32 on the card against the CPU; the reduced config on
     the card against the CPU.
 21. training the attention families: the swa autograd Function at
     width 96 (minicpm3's MLA, 40/40 heads, V zero-padded from 64; bf16
     and float32) and at qwen2-moe's 16/16 heads of 128, dq, dk, dv
     bitwise those of plain autograd, one forward launch;
     ``_kernel_attention`` at the reduced MLA width 48 padded to 64
     against plain autograd at 48 (GATE_SWA); the forward, the
     plain-recompute backward, SDPA's forward and backward and the bounds
     timed; the router's stable sort beside torch.topk at 8192 x 60;
     minicpm3 (16 of 62 layers, b = 2 x 2048) and qwen2-moe (4 of 24
     layers, b = 4 x 2048, the capacity path) at full width, random bf16
     weights drawn on the card, 3 AdamW steps on one fixed batch: loss,
     nll and aux finite, nll falling, two swa launches and one plain
     recompute a layer a step, step wall, tokens/s and peak memory beside
     the step's bound, the dropped share, one step's gradients repeated
     bitwise, the padding experts' gradients exactly zero and the
     router's finite and non-zero, a profiled step (the recompute's, the
     dispatch's, the expert products' and the combine's shares); one sync
     step of each of the six reduced configs on the card against the CPU
     under phase 15's gates.
 22. training recurrentgemma-2b uncut (TRAIN_REC: b = 1 x 4096): the swa
     Function at width 256 with a window, the doubling scan's gradients
     against float64, the steps, float32 ``lamb`` gradients, a bitwise
     repeat, a profiled step and the reduced config against the CPU.
 23. training xlstm-1.3b (TRAIN_XL: b = 1 x 4096, 16 chunks): the mLSTM
     chunk scan's gradients at the model's heads and the sLSTM loop's at
     its width against float64 on the card, timed beside their bounds;
     two AdamW steps at full width, 24 of the 48 layers (nll falling, no
     swa launch, step wall, tokens/s, peak memory, allocator retries,
     float32 ``w_if``, ``skip`` and ``out_norm`` gradients finite and
     non-zero in every layer); at one unit a bitwise repeat, the bf16
     ``r_gates`` gradient against float32 and a profiled step (the chunk
     scan's, the sLSTM loop's and AdamW's shares); the reduced config
     against the CPU.
 24. training whisper-tiny uncut (TRAIN_WH: b = 8 x 4096 tokens over 1500
     frames): the swa Function at width 64, 6/6 heads; the non-causal
     attention's gradients (the encoder's and the cross-attention's
     shapes) against float64, timed beside their bound; three AdamW steps
     (nll falling, swa launches and plain recomputes a step, non-causal
     calls a step, step wall, tokens/s, peak memory, allocator retries);
     every gradient finite, every row of both position tables with a
     gradient; a bitwise repeat; a profiled step (the encoder's, the
     non-causal attention's and AdamW's shares); the reduced config with
     frames against the CPU.

Samples of phases 3-10 are drawn here, seeded, by a chromatic Gibbs sweep
written with neighbour lists in torch on the card; true parameters come
from a seeded torch.Generator. Phase 11 draws through the port's own
samplers. Prints the redesigned kernels' first-version times beside
this run's, one {"kernels": [...]} line and, last, one
{"ok": true, "device": {...}} line; exits non-zero on any failure, and
without a result when there is no CUDA device or no repro_torch beside it.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: relative (normwise) error gates: float32 sums taken in another order
GATE_STATS = 1e-4     # g, K, S: long reductions over samples
GATE_ELEM = 1e-5      # eta, r: short sums over a node's neighbours
#: kernel fit against plain fit, on theta
GATE_THETA = 1e-4

#: flash attention: float32 sums in another order, and (bf16) the kernel's
#: p rounded to bf16 for the p v product, held against the plain version
#: run in float32 on the same bf16 inputs
GATE_SWA = {"float32": 1e-5, "bfloat16": 1e-2}
#: Llama prefill + teacher-forced decode against one full forward, bf16:
#: the decode path rounds its scores to bf16 before the softmax (as the
#: reference does) where the kernel keeps them in float32, and 28 layers of
#: bf16 activations compound it; normwise over the compared logits
GATE_SERVE = 1e-1

#: data-sheet rates by the name nvidia-smi reports (bytes/s, FP32 FLOP/s
#: outside the tensor cores, dense BF16 tensor-core FLOP/s)
CARD_RATES = (("H100 PCIe", 2.0e12, 51e12, 756e12),
              ("H100 NVL", 3.9e12, 60e12, 835e12),
              ("H100", 3.35e12, 67e12, 989e12))

#: planted |coupling| per family of the reference's structure bench
#: (benchmarks/structure_bench.py, BENCH_structure.json "config")
STRUCTURE_COUPLING = {"ising": 0.5, "gaussian": 0.3}
STRUCTURE_F1_FLOOR = 0.95
#: kernel select against plain select on the card: EBIC, relative
GATE_EBIC = 1e-5
#: the deployment select's walls are taken at the default depth (12 lambdas
#: x 40 rounds); only its profiled select and the kernel-against-plain select
#: are cut in depth by these, printed on their lines: a profile of the
#: default depth's 6000-odd launches took minutes to read back
FIELD_SELECT_CUTS = {"n_lambdas": 4, "admm_rounds": 10}

#: the first version of each redesigned kernel, by the tag its timing line
#: prints (NVIDIA H100 80GB HBM3 at 700 W; PERF.md kernel table)
EARLIER_MS = {
    "newton field_ising bucket d=5 k=4096 n=16384": 3.0412,
    "newton euclidean_ising bucket d=17 k=69 n=4000 weighted=False": 0.1048,
    "newton scalefree_ising bucket d=65 k=1 n=4000 weighted=False": 0.2514,
    "newton euclidean_potts3 bucket d=17 k=69 n=4000 weighted=False": 0.2309,
    "swa prefill b=4 s=2048": 1.0146,
    "swa window b=1 s=8192 w=4096": 2.6635,
    "score field_ising n=16384 p=4096 C=1": 54.9393,
    "cl_logits field_ising n=16384 p=4096": 29.3808,
    "gram kernels_bench n=16384 d=512": 0.5524,
}

PAPER_COMBINERS = ("uniform", "diagonal", "optimal", "max")
FIELD_COMBINERS = ("diagonal", "max")

#: phase 11's sampler-law draws: rows and side-by-side chains
SAMPLER_N, SAMPLER_CHAINS = 65536, 256
#: sampler moment error gate, max |mean u - E u| in units of 1/sqrt(n): the
#: reference's conformance tolerances (tests/families/test_conformance.py;
#: the Gaussian's statistics are unbounded)
MOMENT_TOL = {"ising": 4.5, "gaussian": 9.0, "potts": 4.5}
#: exact oracles (float64 enumeration) on the card against the CPU
GATE_ORACLE = 1e-10
#: Fig. 4 at paper size (benchmarks/fig4_large.py, REPRO_BENCH_FULL=1), with
#: the replicates cut to its quick-mode counts (models x sets)
FIG4_NS = (250, 1000, 4000)
FIG4_CUT = {"models": 2, "sets": 2}
#: stationarity of fit_mple's estimate: max |pseudo-score| through the score
#: kernel (the reference's bound, tests/core/test_estimators.py:19-23)
GATE_STATIONARY = 1e-4
#: deployment draws on the 64 x 64 grid
FIELD_DRAW_NS, FIELD_DRAW_CHAINS = (4096, 16384), 256

#: phase 12's hostile star (tests/stream/test_checkpoint.py::_mk, _hostile):
#: the rounds run and the round of the checkpoint; a restored run must
#: equal the uninterrupted one within GATE_RESTORE (rtol 0)
HOSTILE_ROUNDS, HOSTILE_SAVE = 12, 6
GATE_RESTORE = 1e-10
#: phase 12's field drift: rounds, change-point and the jump's scale. With
#: GaussianMRF.random_params' guard (every row of |T| sums to at most 0.9)
#: and degree 4, Gershgorin leaves about 0.005 per entry for I - T to stay
#: positive definite
DRIFT_ROUNDS, DRIFT_AT, DRIFT_SCALE = 16, 8, 0.005
#: the field drift's window and arrivals per node per round (phase 9's rate)
DRIFT_WINDOW, DRIFT_RATE = 2048, 256
#: the simulator's trajectory through the kernels against the plain versions
GATE_TRAJECTORY = 1e-4
#: the field drift's re-drawn tail: the mean over its means and edge second
#: moments of (empirical - exact)^2 n / variance. It is 1 in expectation for
#: rows drawn from the drifted law, with a spread of about 0.01 at these
#: counts; the jump at DRIFT_SCALE raises it by about 0.5 for rows of the
#: other law (phase 12 prints the exact shift), so the controls, the
#: original tail against the drifted law and the re-drawn tail against the
#: undrifted one, must read above the gate
GATE_TAIL_Z2 = 1.15

#: phase 14's serve bench (benchmarks/serve_bench.py at REPRO_BENCH_FULL=1):
#: tenants over two plans on scale_free_graph(24, seed=0), rounds (round 0
#: the warm-up), rows per request, the largest coalesced group
SERVE_TENANTS, SERVE_ROUNDS, SERVE_ROWS, SERVE_COALESCE = 32, 12, 256, 8
#: phase 14's field serving: tenants of one plan on the 64 x 64 grid, rows
#: per request (disjoint blocks of phase 5's rows), stream rounds
FIELD_TENANTS, FIELD_ROWS, FIELD_ROUNDS = 8, 2048, 3
#: a coalesced ticket against the serial server's on the card: theta and
#: every combined estimate, normwise; the union bucket sums each node's
#: samples in another split than the tenant's own bucket
GATE_COALESCE = 1e-4
#: near-singular and unconverged local fits follow the last bits
#: (ROADMAP.md queue 3): the gate holds at the parameters whose owners'
#: serial fits all have a local H of condition number below COND_LIMIT (as
#: the parity tests hold theirs) and a plain float64 Newton step from the
#: served estimate below STEP_LIMIT (the fit converged within the plan's
#: Newton budget); the difference over every parameter is printed beside it
COND_LIMIT, STEP_LIMIT = 1e6, 1e-4

#: phase 15's attention Function checks: the training shape (b, s, h, kh,
#: d: Llama-3.2-3B's heads at the sync trainer's batch and sequence) in
#: bf16, causal and with TRAIN_WINDOW, and a float32 shape
TRAIN_SWA, TRAIN_WINDOW = (2, 2048, 24, 8, 128), 1024
TRAIN_SWA_F32 = (2, 512, 8, 4, 64)
#: phase 15's synchronous trainer (full width and depth) and consensus
#: trainer (full width, depth cut: two pods' stacked parameters, moments,
#: duals and theta_bar are about 30 bytes a parameter, so 28 layers would
#: need about 108 GB); AdamW peak lr, warmup 2 steps, cosine decay
TRAIN_SYNC = {"batch": 2, "seq": 2048, "steps": 6}
TRAIN_CONSENSUS = {"layers": 8, "pods": 2, "h_steps": 2, "rounds": 2,
                   "batch": 4, "seq": 2048}
TRAIN_LR = 5e-5
#: the reduced config (float32) on the card against the port's CPU path:
#: sequence length; nll relative (float32 sums in another order). A step's
#: or round's parameters: Adam's first steps are about lr * sign(g), so a
#: coordinate whose gradient is at float32 noise level moves by an
#: unpredictable amount up to 2 lr (a sign flip), and the max vote may
#: pick the other pod where the pods' Fisher weights nearly tie. So at
#: most GATE_TRAIN_FLIPS of the coordinates may lie more than lr *
#: TRAIN_APART apart, and the others lie within GATE_TRAIN_STEP of the
#: update's size (per leaf, normwise; the CPU parity tests read up to
#: 3.2e-4 port against reference). AdamW from the same state and
#: gradients on the card and the CPU: per leaf, normwise, within
#: GATE_TRAIN_ADAM
TRAIN_REDUCED_SEQ, TRAIN_APART = 128, 1e-2
GATE_TRAIN_LOSS, GATE_TRAIN_STEP, GATE_TRAIN_FLIPS = 1e-5, 1e-3, 1e-4
GATE_TRAIN_ADAM = 1e-6

#: phase 21's attention-family training at full width, depth cut to fit
#: one card: (architecture, layers, batch, sequence, steps on one fixed
#: batch). minicpm3 at TRAIN_SYNC's shape, 16 of 62 layers (1.379 B
#: parameters, about 15.4 GiB of bf16 parameters and gradients and float32
#: moments); qwen2-moe at phase 16's prefill shape, 8192 tokens, so the
#: capacity path routes, 4 of 24 layers (3.043 B parameters, about 34.0
#: GiB of state, and 4.6 GiB of float32 logits)
TRAIN_FAMILIES = (("minicpm3-4b", 16, 2, 2048, 3),
                  ("qwen2-moe-a2.7b", 4, 4, 2048, 3))
#: phase 21's Function checks at width 96: minicpm3's MLA (40/40 heads, V
#: zero-padded from 64) at TRAIN_SYNC's batch and length in bf16 and at
#: TRAIN_SWA_F32's length in float32; and the reduced MLA's width 48,
#: padded to 64 inside ``_kernel_attention`` (b, s, heads)
TRAIN_SWA96 = (2, 2048, 40, 96, 64)
TRAIN_PAD48 = (2, 512, 4)

#: phase 16's attention families, served one after another on one card at
#: full width with random weights: (architecture, depth or None for the
#: config's own). Depth is cut only where the weights do not fit
ZOO = (
    ("qwen2-moe-a2.7b", None),
    ("minicpm3-4b", None),
    ("phi3-mini-3.8b", None),
    ("glm4-9b", None),
    # 48 layers are 68.6 GB of bf16 weights, and materialize draws the
    # stacked MLP leaf in float32 first (34.6 GB): they do not fit in 80 GB
    ("chameleon-34b", 16),
    # 48 layers are 215.6 GB of weights; the four-card version is item 12's
    ("llama4-scout-17b-a16e", 6),
)
#: phase 16's teacher-forced tokens after the prompt
ZOO_EXTRA = 4

#: phase 17's shapes (n, p): the reference's conformance shapes of the score
#: and logits kernels, an odd p (single bfloat16 loads in the Gram body) and
#: a p that is even but not a multiple of 8 (bfloat16 pairs)
BF16_SHAPES = ((32, 10), (130, 128), (200, 150), (5, 260), (1001, 37),
               (333, 130))
#: phase 7's masks past p = 128 (the pre-pass, the sparse and the dense
#: walk): (mask, n, p)
BF16_MASKS = (("density .05", 333, 260), ("density 1.0", 333, 260),
              ("grid 16x16", 333, 256))
#: the reference's Gram shapes (tests/kernels/test_kernels.py), then a pair
#: path
BF16_GRAM = ((100, 7), (512, 128), (1000, 40), (3, 300), (1001, 130))
#: the non-finite cases of tests/test_torch_cuda.py: (p, mask, poison)
BF16_NONFINITE = ((257, "density .05", "F and Theta"),
                  (100, "density .05", "F and Theta"),
                  (257, "grid 16x16 + isolated node", "F and Theta"),
                  (257, "density .05", "Theta only"),
                  (257, "density .05", "F only"),
                  (1100, "density .05", "a row of F"))
#: a bfloat16 G against the plain version on the float32 upcasts (float32
#: sums in another order, as the float32 test of gram)
GATE_GRAM = 1e-5
#: the no-upcast check: what a bfloat16 call may allocate above its outputs
#: and scratch (the caching allocator rounds a large block up to 2 MiB); a
#: float32 copy of the field F is 256 MiB
ALLOC_SLACK = 8 * 2**20
#: the expert models' teacher-forced check in float32 at full width: depth
#: (float32 weights of all 24 qwen2-moe layers are 60.6 GB; a llama4-scout
#: layer is 17.5 GB and its vocabulary's embedding and head 8.3 GB), and
#: its gate (float32 sums in another order through a few layers)
ZOO_F32_LAYERS = {"qwen2-moe-a2.7b": 4, "llama4-scout-17b-a16e": 1}
GATE_TF32 = 1e-3
#: phase 18's long request for recurrentgemma-2b (batch, prompt, new
#: tokens): a prompt four windows long, so the 2048-token window bites in
#: the prefill kernel and the ring buffer of every attention layer wraps in
#: decode; phase 8's request is the other
RG_LONG = (1, 8192, 16)
#: phase 19's long request for xlstm-1.3b (batch, prompt, new tokens): 16
#: chunks of 256 carried through (C, n, m), 4096 sLSTM steps a layer;
#: phase 8's request is the other. Cut from 8192 tokens when phase 23 took
#: the script to 943 s with the kernels already built (PERF.md)
XL_LONG = (1, 4096, 16)
#: phase 19's teacher-forced check, gated in float32 (GATE_TF32) over this
#: many layers at phase 8's request and at XL_LONG: full depth, and one
#: unit (7 mLSTM, 1 sLSTM) at the long request, whose float32 prefill and
#: forward at full depth took about 30 s over 8448 tokens (the sLSTM
#: loop). In bf16 the prefill already differs from the forward over a
#: longer sequence, the same arithmetic at another length, by 0.3
#: normwise (an H100 80GB HBM3 at 700 W; PERF.md): the GEMMs round
#: differently at another row count, and each of the 48 layers adds about
#: 6e-3 to the residual stream's difference and passes it on (float32:
#: 2.4e-6 a layer, 2.3e-4 after 48)
XL_F32_LAYERS = (48, 8)
#: the long request's profiled prefill, cut to this many tokens at b = 1:
#: its chunk-scan work and sLSTM steps both grow linearly in s, so the
#: shares stand for the 8192-token request's (16.7 % and 75.6 % there
#: against 16.9 % and 75.2 % at 2048, PERF.md), and that trace
#: (4.97 M events) took 153 s to read back
XL_PROFILED = 1024
#: the mLSTM chunk scan against its chunk-1 recurrence on the card, float32
#: (TF32 off), normwise: the same sums in another order through the
#: normaliser max(|q.n|, exp(-m)) (on the CPU 2e-6 to 5e-5 at width 1024,
#: growing with the gates' scale)
GATE_SCAN = 1e-4

#: phase 20's requests for whisper-tiny (batch, frames, prompt, new tokens)
#: over one 30-second window's 1500 frame embeddings: whisper's 448-token
#: decoder context, 224 tokens of previous-text conditioning and
#: sample_len 224; and the first segment of a file, a 4-token
#: start-of-transcript prompt
WH_REQUEST = (8, 1500, 224, 224)
WH_FIRST = (8, 1500, 4, 224)
#: decode steps of phase 20's profiled decode
WH_PROFILED_STEPS = 16

#: phase 22's RG-LRU training: recurrentgemma-2b uncut (26 layers: eight
#: rec/rec/attn units under remat and two remainder rec layers outside it;
#: 3.550 B parameters, random bf16 weights drawn on the card), AdamW steps
#: on one fixed SyntheticLM batch of batch x seq at train_4k's length, so
#: the 2048-token window bites. Reckoned before the first run: bf16
#: parameters and gradients 6.6 GiB each, float32 moments 26.4 GiB, float32
#: logits 3.9 GiB a copy, about 1 GB of saved doubling scan a rec layer;
#: 52-62 GiB in all
TRAIN_REC = {"batch": 1, "seq": 4096, "steps": 3}
#: phase 22's swa Function checks at recurrentgemma's width (10/1 heads of
#: 256): (dtype, batch, sequence, window): its training shape, float32 at a
#: shorter length with the window still biting, and a small window
TRAIN_REC_SWA = (("bfloat16", 1, 4096, 2048), ("float32", 1, 2560, 2048),
                 ("bfloat16", 2, 300, 64))
#: the doubling scan's gradients on the card: (batch, sequence, width) of a
#: training step's rec layer, float32, against a float64 sequential loop on
#: the card (normwise; decays a = u^0.01, median 0.993, so the memory is
#: long: on the CPU at width 64 the float32 scan reads 2.9e-7 against
#: float64, 5.8e-8 at the model's initial decays)
TRAIN_REC_SCAN = (1, 4096, 2560)
GATE_SCAN_GRAD = 1e-6
#: phase 23's xLSTM training: xlstm-1.3b at full width (48 layers: six
#: units of seven mLSTM and one sLSTM under remat; 3.682 B parameters,
#: random bf16 weights drawn on the card), AdamW steps on one fixed SyntheticLM batch
#: of batch x seq at train_4k's length (16 chunks of 256). Reckoned before
#: the first run: bf16 parameters and gradients 6.9 GiB each, float32
#: moments 27.4 GiB, float32 logits about 0.8 GiB a copy, and one unit's
#: graph under remat (the chunk scan keeps C, 16 MiB a chunk and layer at
#: b = 1, and its float32 q, k, v; the sLSTM keeps its 4096 cell steps) a
#: few GiB: 50-55 GiB in all. At full depth a step took 76-95 s (the
#: sLSTM loop is host-paced) and peaked 49.04-49.10 GiB above what was
#: held (PERF.md), which took the script past 1000 s: the steps run three
#: of the six units (24 layers, the 7:1 pattern kept, the width uncut)
TRAIN_XL = {"batch": 1, "seq": 4096, "steps": 2, "layers": 24}
#: the depth of phase 23's bitwise repeat and profiled step: one unit (a
#: full-depth step launches over a million kernels)
TRAIN_XL_UNIT = 8
#: the mLSTM chunk scan's gradients on the card: (batch, heads, sequence,
#: head width), the model's heads over four chunks, float32 (TF32 off),
#: against the same recurrence in its parallel form in float64 (normwise
#: per input). Forget gates log-sigmoid(N(5, 1)), near 1 as a trained
#: model's (the xLSTM paper starts their bias at 3 to 6), so the carried
#: (C, n, m) weighs in; at the model's initial gates (about 0.5) a chunk
#: decays it by about exp(-177)
TRAIN_XL_SCAN = (1, 4, 1024, 1024)
#: the sLSTM position loop's gradients on the card: (batch, sequence,
#: width) at the model's width, float32, against the cell run in float64
TRAIN_XL_SLSTM = (1, 512, 2048)
#: normwise, float32 against float64 (on a CPU at these shapes they read
#: up to 1.8e-5 and 4.4e-7)
GATE_XL_SCAN_GRAD, GATE_XL_SLSTM_GRAD = 1e-4, 1e-5
#: the reduced xLSTM's step, card against CPU: its float32 gradients at
#: initialisation sit 1e-4 to 1.5e-3 per leaf from a float64 run of the
#: recurrences, whichever float32 implementation computes them (the
#: reference on the CPU 1.9e-4 and 2.2e-4 on this phase's and the card
#: test's states, 1.5e-3 on another draw; the port on the CPU 9.6e-5 and
#: 4.6e-4): the backward grows about 300-fold from the head to the
#: embedding there and carries the rounding with it, so phase 15's
#: GATE_STATS and GATE_TRAIN_FLIPS do not hold between two float32 runs.
#: Gradients within three times the largest distance (1.5e-3); after the
#: step at most three times the largest share of coordinates that the
#: reference's step and the port's set more than lr * TRAIN_APART apart on
#: the CPU (2.6e-4)
GATE_XL_TRAIN_GRAD, GATE_XL_TRAIN_FLIPS = 4.5e-3, 7.8e-4

#: phase 24's whisper training: whisper-tiny uncut (4 encoder and 4 decoder
#: layers, d 384, 6/6 heads of 64; about 58.6 M parameters, of which the
#: untied head and the embedding are 20.0 M each; random bf16 weights and
#: frame embeddings drawn on the card), AdamW steps on one fixed
#: SyntheticLM batch of batch x seq decoder tokens at train_4k's length
#: (every row of the decoder's 4096-row position table) over one 30-second
#: window's frames, phase 20's batch. Reckoned before the first run:
#: parameters, gradients and moments under 1 GiB; float32 logits 6.8 GB a
#: copy at 8 x 4096 x 51968, two or three held by the cross-entropy; one
#: decoder layer's plain recompute holds (8, 6, 4096, 4096) float32 scores,
#: 3.2 GB a copy; the encoder runs outside remat, so its four layers' (8,
#: 6, 1500, 1500) float32 softmax outputs stay live (0.4 GB each): 20-30
#: GiB in all (measured: 35.90-35.96 GiB, PERF.md). The step's bound,
#: about 9 ms: 6.3 TFLOP of products and 2.5 TFLOP of attention (causal
#: self, cross, encoder) at BF16
TRAIN_WH = {"batch": 8, "seq": 4096, "frames": 1500, "steps": 3}
#: phase 24's swa Function checks at whisper's width (6/6 heads of 64,
#: causal): (dtype, batch, sequence): the training shape, and float32 at a
#: shorter length
TRAIN_WH_SWA = (("bfloat16", 8, 4096), ("float32", 2, 1024))
#: phase 24's non-causal attention (``_full_attention``, float32, TF32 off)
#: against the same attention in float64 on the card: (batch, queries,
#: keys) of the encoder's self-attention and of the cross-attention at
#: TRAIN_WH's shape, normwise per input (on a CPU at b = 1 they read 4.5e-7
#: to 1.1e-6)
TRAIN_WH_FULL = ((8, 1500, 1500), (8, 4096, 1500))
GATE_FULL_GRAD = 1e-5

def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def card_rates(name: str):
    """(bytes/s, FP32 FLOP/s, BF16 FLOP/s) of the card."""
    for key, *rates in CARD_RATES:
        if key in name:
            return rates
    return CARD_RATES[-1][1:]


class Timer:
    """CUDA-event timing of a callable, mean ms over ``reps`` launches."""

    def __init__(self, torch):
        self.torch = torch

    def __call__(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def turns(self, plain, kernel, library, reps: int):
        """(kernel_ms, plain_ms, library_ms) timed plain, kernel, kernel,
        plain (then the library call), so drift hits both alike."""
        p1 = self(plain, reps)
        k1 = self(kernel, reps)
        k2 = self(kernel, reps)
        p2 = self(plain, reps)
        lib = self(library, reps) if library is not None else None
        return (k1 + k2) / 2, (p1 + p2) / 2, lib


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time per call of ``fn``: the summed durations of the
    kernels it launched, under torch.profiler. Unlike back-to-back CUDA
    events it leaves out the host's time between launches, which sets the
    pace of a call whose kernels take a few microseconds. The calls are
    traced in the profiler's second cycle, after a warm-up cycle of as many
    (a trace's first kernel was lost at times); nan when the trace holds
    fewer kernel events than calls, since every call launches at least
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return sum(us) / 1e3 / reps if len(us) >= reps else float("nan")


# ---------------------------------------------------------------- sampling
def gibbs_sample(torch, graph, family: str, theta, n: int, sweeps: int,
                 gen, device, q: int = 3):
    """n samples from n independent chains of a chromatic Gibbs sampler.

    Neighbour lists on the card: per node, its neighbours' columns (padded
    with a dummy all-zero column) and the matching edge parameters; a
    color class updates in one gather, never a dense p x p product.
    """
    p, C = graph.p, (1 if family == "ising" else q - 1)
    deg = [len(graph.incident_edges(i)) for i in range(p)]
    dmax = max(1, max(deg))
    nbr = torch.full((p, dmax), p, dtype=torch.int64)
    w = torch.zeros((p, dmax, C), dtype=torch.float32)
    th = theta.to(torch.float32).cpu()
    for i in range(p):
        for s, k in enumerate(graph.incident_edges(i)):
            a, b = graph.edges[k]
            nbr[i, s] = b if a == i else a
            w[i, s] = th[p * C + k * C: p * C + (k + 1) * C]
    h = th[: p * C].reshape(p, C).to(device)
    nbr, w = nbr.to(device), w.to(device)
    colors = graph.greedy_coloring()
    classes = [torch.as_tensor((colors == c).nonzero()[0], device=device)
               for c in range(int(colors.max()) + 1)]
    X = torch.zeros((n, p + 1), dtype=torch.float32, device=device)
    if family == "ising":
        X[:, :p] = torch.where(torch.rand((n, p), generator=gen,
                                          device=device) < 0.5, 1.0, -1.0)
    else:
        X[:, :p] = torch.randint(0, q, (n, p), generator=gen,
                                 device=device).float()
    chans = torch.arange(1, q, device=device, dtype=torch.float32)
    for _ in range(sweeps):
        for nodes in classes:
            vals = X[:, nbr[nodes]]                          # (n, kc, dmax)
            u = torch.rand((n, len(nodes)), generator=gen, device=device)
            if family == "ising":
                eta = h[nodes, 0] + (vals * w[nodes, :, 0]).sum(-1)
                X[:, nodes] = torch.where(u < torch.sigmoid(2.0 * eta),
                                          1.0, -1.0)
            else:
                feat = (vals[..., None] == chans).float()    # (n,kc,dmax,C)
                eta = h[nodes] + (feat * w[nodes]).sum(-2)   # (n, kc, C)
                logits = torch.cat([torch.zeros_like(eta[..., :1]), eta], -1)
                cdf = torch.softmax(logits, -1).cumsum(-1)
                X[:, nodes] = (cdf[..., :-1] < u[..., None]).sum(-1).float()
    return X[:, :p].contiguous()


def device_profile(torch, label: str, fn):
    """The device's busy share of one call of ``fn`` and its top device
    kernels, under torch.profiler. Busy time is the union of the device
    events' intervals (kernels, copies, fills); the CPU ops that launched
    them are not counted again. Returns {kernel name: (us, count)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in device):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6
    print(f"  profiled {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%, under the profiler)")
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"    device {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    return by_name


def phase9(torch, np, A, graph, truth, X_field, smi, gate, launches,
           plain_cuda_calls, nmod, kmod):
    """Streaming, joint ADMM and the simulator on the 64 x 64 grid, on the
    card: every refit and prox round through the Newton kernel, every score
    norm through the score kernel, no plain version on a CUDA tensor."""
    from repro_torch.core import combine
    from repro_torch.stream import ArrivalSpec, NetworkConfig

    print(f"phase 9: streaming, joint ADMM and the simulator on the "
          f"{graph.p}-node grid ({smi})", flush=True)
    Xs = X_field[:16384]
    plan = A.Plan(graph=graph, family="ising", combiners=FIELD_COMBINERS)
    sess = plan.session()

    def counted(fn):
        """fn() on the kernel path, every count set to 0 just before and
        read just after: (result, wall s, Newton launches, score launches,
        plain calls on CUDA tensors)."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl, sl = nmod.bucket_newton_stats.launches, \
            kmod.cl_score_channels.launches
        launches["newton"] += nl
        launches["score_c1"] += sl
        return out, wall, nl, sl, plain_cuda_calls["n"]

    def mse(theta):
        d = theta - truth
        return float(d @ d)

    # ---- stream: 8 chunks of 2048 from a 2048-row buffer, a refit each
    est = sess.stream(capacity=2048)
    walls, newton = [], []
    clean = True
    for c in range(8):
        est.ingest(Xs[c * 2048:(c + 1) * 2048])
        _, wall, nl, sl, pc = counted(est.refit)
        walls.append(wall)
        newton.append(nl)
        clean &= nl >= 1 and pc == 0
    batch = sess.fit(Xs)
    dth = max(float(np.max(np.abs(a.theta - b.theta)))
              for a, b in zip(est.fits, batch.fits))
    gate(dth <= 1e-5 and clean and est.buffer.capacity == 16384,
         f"stream: 8 chunks of 2048 (capacity 2048 -> "
         f"{est.buffer.capacity}) against one fit of {Xs.shape[0]} rows: "
         f"theta max diff {dth:.2e}; Newton launches per refit {newton}")
    theta_s = combine(graph, est.fits, "diagonal")
    score, _, _, sl, pc = counted(lambda: est.score_norm(theta_s))
    gate(sl == 1 and pc == 0 and np.isfinite(score),
         f"stream score_norm {score:.4e}: score launches {sl}, plain calls "
         f"on CUDA tensors {pc}")
    print(f"  stream refit wall: cold {walls[0]:.4f} s, warm median "
          f"{statistics.median(walls[1:]):.4f} s (range "
          f"{min(walls[1:]):.4f}-{max(walls[1:]):.4f}); Newton iterations "
          f"per refit {newton} (one bucket); diagonal MSE to the truth "
          f"{mse(theta_s):.4f}", flush=True)
    del est

    # ---- windowed heterogeneous refit: kernel against plain
    sess_w = plan.replace(stream_window=4096).session()
    half = np.where(np.arange(graph.p) < graph.p // 2, 8192, 16384)
    pair = [sess_w.stream(capacity=16384) for _ in range(2)]
    for e in pair:
        e.extend_pool(Xs)
        e.advance(half)
    fk, wall_k, nl, _, pc = counted(pair[0].refit)
    t0 = time.perf_counter()
    fp = pair[1].refit(use_kernel=False)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    dth = max(float(np.max(np.abs(a.theta - b.theta)))
              for a, b in zip(fk, fp))
    gate(dth <= GATE_THETA and nl >= 1 and pc == 0,
         f"stream window 4096, half the nodes at 8192 rows and half at "
         f"16384: kernel vs plain refit theta max diff {dth:.2e}; wall "
         f"{wall_k:.4f} s (plain {wall_p:.4f} s), {nl} Newton launches")
    del pair, fk, fp

    # ---- joint: ADMM from the diagonal one-step, 30 rounds x 15 Newton
    sess_j = A.Plan(graph=graph, admm_init="diagonal").session()
    fit_iters = {}
    sess_j.fit_local(Xs, iters=fit_iters)
    res_j, wall_j, nl, sl, pc = counted(lambda: sess_j.joint(Xs))
    res_p = sess_j.joint(Xs, use_kernel=False)
    dth = float(np.max(np.abs(res_j.theta - res_p.theta)))
    pr = res_j.primal_residual
    rounds = sess_j.plan.admm_iters
    gate(dth <= GATE_THETA and bool(np.all(np.isfinite(res_j.trajectory)))
         and pr[-1] < pr[0] and nl >= sum(fit_iters.values()) + rounds
         and sl == 1 and pc == 0,
         f"joint: kernel vs plain theta max diff {dth:.2e}; primal residual "
         f"{pr[0]:.3e} -> {pr[-1]:.3e}; Newton launches {nl} (local fits "
         f"{sum(fit_iters.values())} + {rounds} prox rounds x 1..."
         f"{sess_j.plan.admm_newton_iters}), score launches {sl}, plain "
         f"calls on CUDA tensors {pc}")
    print(f"  joint wall {wall_j:.3f} s (plain {res_p.wall_s:.3f} s), "
          f"{rounds} rounds; MSE to the truth: joint {mse(res_j.theta):.4f},"
          f" diagonal one-step {mse(batch.combined['diagonal']):.4f}; "
          f"comm scalars {res_j.comm_scalars['admm']}", flush=True)
    device_profile(torch, "joint", lambda: sess_j.joint(Xs))
    del res_j, res_p, batch

    # ---- simulate: 16 rounds of 256 arrivals per node on a perfect network
    def rounds_of(sim, n_rounds):
        walls, errs, clean = [], [], True
        for _ in range(n_rounds):
            res, wall, nl, _, pc = counted(lambda: sim.run(1))
            walls.append(wall)
            errs.append(float(res.err[-1]))
            clean &= nl >= 1 and pc == 0
        return res, walls, errs, clean

    sim = sess.simulate(X_field, arrivals=ArrivalSpec(rate=256),
                        theta_star=truth)
    res, walls, errs, clean = rounds_of(sim, 16)
    n_seen = int(res.samples_seen[-1])
    want = sess.fit(X_field[:n_seen]).combined["diagonal"]
    dth = float(np.max(np.abs(res.theta[-1] - want)))
    score, _, _, sl, pc = counted(lambda: sim.est.score_norm(res.theta[-1]))
    gate(dth <= 1e-5 and clean and sl == 1 and pc == 0,
         f"simulate one_step diagonal, perfect network, 16 rounds: last "
         f"estimate vs the global diagonal combine of a fit on {n_seen} rows"
         f": max diff {dth:.2e}; Newton launches in every round {clean}; "
         f"score_norm {score:.4e}")
    print(f"  simulate one_step: median round wall "
          f"{statistics.median(walls):.4f} s (range {min(walls):.4f}-"
          f"{max(walls):.4f}); scalars sent {int(res.scalars_sent[-1])}; "
          f"MSE round 1 {errs[0]:.4f} -> round 16 {errs[-1]:.4f}",
          flush=True)
    del sim
    sim = sess.simulate(X_field, estimator="admm",
                        arrivals=ArrivalSpec(rate=256), theta_star=truth,
                        network=NetworkConfig(drop_prob=0.1, seed=0))
    res, walls, errs, clean = rounds_of(sim, 16)
    gate(bool(np.all(np.isfinite(res.theta))) and errs[-1] < errs[0]
         and clean,
         f"simulate admm, drop_prob 0.1: MSE round 1 {errs[0]:.4f} -> round "
         f"16 {errs[-1]:.4f}; Newton launches in every round {clean}")
    print(f"  simulate admm: median round wall {statistics.median(walls):.4f}"
          f" s (range {min(walls):.4f}-{max(walls):.4f}); scalars sent "
          f"{int(res.scalars_sent[-1])} (dropped "
          f"{sim.net.scalars_dropped})", flush=True)
    del sim
    torch.cuda.empty_cache()


def planted_structure(torch, np, graph, family, n, gen, device):
    """The reference structure bench's planted model on ``graph``: zero
    singletons, edge couplings of |STRUCTURE_COUPLING| with signs from
    RandomState(7), sampled on the card (Ising by the chromatic Gibbs
    sampler, Gaussian exactly from its precision matrix)."""
    signs = np.where(np.random.RandomState(7).rand(graph.m) < 0.5, 1.0, -1.0)
    theta = torch.zeros(graph.p + graph.m, dtype=torch.float64)
    theta[graph.p:] = torch.as_tensor(STRUCTURE_COUPLING[family] * signs)
    if family == "ising":
        return gibbs_sample(torch, graph, "ising", theta, n, 150, gen,
                            device)
    prec = torch.eye(graph.p, dtype=torch.float64)
    e = torch.as_tensor(graph.edges, dtype=torch.int64)
    prec[e[:, 0], e[:, 1]] = -theta[graph.p:]
    prec[e[:, 1], e[:, 0]] = -theta[graph.p:]
    chol = torch.linalg.cholesky(torch.linalg.inv(prec)).to(device)
    z = torch.randn((n, graph.p), generator=gen, device=device,
                    dtype=torch.float64)
    return (z @ chol.T).float().contiguous()


def range_shares(torch, prof, names):
    """Device time of a profile by record_function range, from the
    profiler's raw events: a device event counts for a range when the op
    that launched it (its linked correlation id) started inside one of that
    range's spans, on any thread (each name's spans must not overlap).
    Returns (busy seconds, device ns, {name: (ns, spans)}, {device kernel
    name: (us, count)}, events read)."""
    from torch.autograd import DeviceType

    ranges = {mark: [] for mark in names}
    op_start, device = {}, []
    n_events = 0
    for e in prof.profiler.kineto_results.events():
        n_events += 1
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in ranges:
                ranges[name].append((e.start_ns(), e.end_ns()))
            elif not name.startswith("cu"):      # not a runtime API call
                op_start[e.correlation_id()] = e.start_ns()
        elif name not in ranges:
            device.append((name, e.start_ns(), e.end_ns(),
                           e.linked_correlation_id()))
    busy_ns, end, kernel_ns = 0, float("-inf"), 0
    for _, a, b, _ in sorted(device, key=lambda x: x[1]):
        kernel_ns += b - a
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    marked = {}
    for mark in names:
        spans = sorted(ranges[mark])
        starts = [lo for lo, _ in spans]
        marked_ns = 0
        for _, a, b, link in device:
            t = op_start.get(link)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                marked_ns += b - a
        marked[mark] = (marked_ns, len(spans))
    by_name = {}
    for name, a, b, _ in device:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + (b - a) / 1e3, n + 1)
    return busy_ns / 1e9, kernel_ns, marked, by_name, n_events


def marked_profile(torch, label: str, fn, mod, attr: str, what: str,
                   noun: str, more=()):
    """One call of ``fn`` under torch.profiler: prints the device's busy
    share and the share of its device time spent in the kernels that
    ``mod.attr`` launched (marked by a record_function range around that
    function for this one call, and named ``what`` on the line: the bucket
    design of ``core/batched.py::_bucket_design``, rebuilt in every prox
    round, the RG-LRU scan, the mLSTM chunk scan), and the same for each
    (mod, attr, what, noun) of ``more`` (the sLSTM position loop), and
    returns (what ``fn`` returned, {device kernel name: (us, count)}).

    It reads the profiler's raw events: a device event counts for a range
    when the op that launched it (its linked correlation id) started
    inside one of the range's calls. Building the profiler's event tree
    (``prof.events()``) costs tens of microseconds an event, minutes for a
    prefill whose sLSTM loop launches a million kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    marks = [(mod, attr, what, noun)] + list(more)
    plain = [getattr(m, a) for m, a, _, _ in marks]
    names = [w.replace(" ", "_") for _, _, w, _ in marks]

    def traced(marked, mark):
        def call(*args, **kwargs):
            with record_function(mark):
                return marked(*args, **kwargs)
        return call

    for (m, a, _, _), marked, mark in zip(marks, plain, names):
        setattr(m, a, traced(marked, mark))
    t_all = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for (m, a, _, _), marked in zip(marks, plain):
            setattr(m, a, marked)
    busy, kernel_ns, marked, by_name, n_events = range_shares(
        torch, prof, names)
    shares = [f"{w} {marked[mark][0] / 1e6:.1f} ms over {marked[mark][1]} "
              f"{n} = {100 * marked[mark][0] / max(kernel_ns, 1):.1f}%"
              for (_, _, w, n), mark in zip(marks, names)]
    print(f"  profiled {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%, under the profiler); "
          f"{'; '.join(shares)} of {kernel_ns / 1e6:.1f} ms of device time "
          f"({n_events} events; {time.perf_counter() - t_all:.1f} s with the "
          f"trace's read-back)", flush=True)
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"    device {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    return out, by_name


def phase10(torch, np, A, g_field, X_field, smi, gate, launches,
            plain_cuda_calls, nmod, gen, dev, bucket_inputs, check_newton,
            time_newton):
    """Structure learning on the card: session.select through the Newton
    kernel at the reference's structure-bench size and at the deployment
    scale, and the Newton kernel against its plain version at the
    deployment select's buckets (phase 3's helpers)."""
    from repro_torch.core import Graph, batched as bmod
    from repro_torch.core import grid_graph
    from repro_torch.structure import candidate_graph
    from repro_torch.structure import solver as ssolver

    print(f"phase 10: structure learning (session.select) on the card "
          f"({smi})", flush=True)
    # every Newton iteration goes through the dispatch op; count the calls
    # (all of them, and those inside prox rounds) and the prox rounds
    calls = {"newton": 0, "prox_newton": 0, "prox_rounds": 0}
    newton_op, prox = bmod.bucket_newton_stats_op, ssolver.prox_update_flat

    def counted_op(*args, **kwargs):
        calls["newton"] += 1
        return newton_op(*args, **kwargs)

    def counted_prox(*args, **kwargs):
        calls["prox_rounds"] += 1
        before = calls["newton"]
        out = prox(*args, **kwargs)
        calls["prox_newton"] += calls["newton"] - before
        return out

    bmod.bucket_newton_stats_op = counted_op
    ssolver.prox_update_flat = counted_prox

    def hold_captured(label):
        """Phase 3's check at every bucket shape captured since the last
        call (W drawn: at a converged iterate g cancels to near 0)."""
        for (kind, shape, weighted), (Zb, b_, xi, sw) in sorted(
                seen.items()):
            k, Cb, d, n = shape
            W = 0.05 * torch.randn((k, d * Cb), generator=w_gen, device=dev)
            check_newton(f"{label} bucket k={k} C={Cb} d={d} n={n} "
                         f"weighted={weighted}", kind, Zb, b_, xi, W, sw)
        print(f"  {label}: the Newton kernel held against its plain version "
              f"at {len(seen)} bucket shapes no earlier check covered",
              flush=True)
        seen.clear()
        torch.cuda.empty_cache()

    def counted(fn):
        """fn() with every count set to 0 just before and read just after:
        (result, wall s, Newton launches, iterations, prox iterations, prox
        rounds, plain calls on CUDA tensors)."""
        nmod.bucket_newton_stats.launches = 0
        plain_cuda_calls["n"] = 0
        for key in calls:
            calls[key] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl = nmod.bucket_newton_stats.launches
        launches["newton"] += nl
        return (out, wall, nl, calls["newton"], calls["prox_newton"],
                calls["prox_rounds"], plain_cuda_calls["n"])

    try:
        # ---- the reference's structure bench: 5 x 6 grid, n = 2000, full
        g = grid_graph(5, 6)
        for family in ("ising", "gaussian"):
            X = planted_structure(torch, np, g, family, 2000, gen, dev)
            X2 = planted_structure(torch, np, g, family, 2000, gen, dev)
            sess = A.Plan(graph=g, family=family, structure=A.StructureSpec(
                policy="full")).session()
            res, wall, nl, it, pit, rounds, pc = counted(
                lambda: sess.select(X))
            f1 = res.edge_metrics(g.edges)["f1"]
            gate(f1 >= STRUCTURE_F1_FLOOR and nl == it and nl >= pit > 0
                 and pit >= rounds and pc == 0,
                 f"select {family} grid 5x6 n=2000 full ({len(res.candidate_edges)}"
                 f" candidates, {len(res.lambdas)} lambdas, vote "
                 f"{res.vote_rule}): F1 {f1:.3f}, |support| "
                 f"{len(res.support)}/{g.m}; wall {wall:.3f} s; Newton "
                 f"launches {nl} = iterations {it} (prox {pit} over {rounds} "
                 f"ADMM rounds); plain calls on CUDA tensors {pc}")
            t0 = time.perf_counter()
            plain = sess.select(X, use_kernel=False)
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
            eb = float(np.max(np.abs(res.ebic - plain.ebic)
                              / np.abs(plain.ebic)))
            gate(res.support == plain.support
                 and res.lambda_selected == plain.lambda_selected
                 and eb <= GATE_EBIC,
                 f"select {family}: kernel vs plain: same support "
                 f"{res.support == plain.support}, same lambda "
                 f"{res.lambda_selected:.5g} / {plain.lambda_selected:.5g}, "
                 f"EBIC rel {eb:.2e}; plain wall {wall_p:.3f} s")
            _, cand = bucket_inputs(Graph(g.p, res.candidate_edges), family,
                                    X, False)
            for _, args in cand:
                k, C, d, n = args[0].shape
                tag = f"structure_bench_{family} bucket d={d} k={k} n={n}"
                check_newton(tag, family, *args)
                time_newton(tag, family, args, 50)
            del cand
            warm, wall_w, nl, it, _, _, pc = counted(lambda: sess.select(X2))
            f1w = warm.edge_metrics(g.edges)["f1"]
            gate(warm.new_compiles == 0 and warm.path_compiles == 0
                 and f1w >= STRUCTURE_F1_FLOOR and nl == it and pc == 0,
                 f"select {family} on fresh same-shape data: F1 {f1w:.3f}, "
                 f"new_compiles {warm.new_compiles}, wall {wall_w:.3f} s, "
                 f"Newton launches {nl} = iterations {it}")
            del X, X2, sess, res, plain, warm

        # ---- deployment scale: the 64 x 64 grid's rows, policy knn
        spec = A.StructureSpec(policy="knn", knn_k=8)
        sess = A.Plan(graph=g_field, structure=spec).session()
        Xa, Xb = X_field[:16384], X_field[16384:]

        # the Newton kernel at the candidate graph's own buckets (the wide
        # regime at n = 16384, split sums included), against its plain
        # version, and timed beside it; the candidates are screened as
        # select screens them
        g_cand = candidate_graph(spec, g_field.p, X=Xa.to(torch.float64),
                                 family=sess.family)
        buckets = ", ".join(f"d={b.deg_pad + 1} k={len(b.nodes)}"
                            for b in bmod.degree_buckets(g_cand))
        _, cand = bucket_inputs(g_cand, "ising", Xa, False)
        for _, args in cand:
            k, C, d, n = args[0].shape
            tag = f"field_select bucket d={d} k={k} n={n}"
            check_newton(tag, "ising", *args)
            time_newton(tag, "ising", args, 10)
        del cand
        torch.cuda.empty_cache()

        res, cold, nl, it, pit, rounds, pc = counted(lambda: sess.select(Xa))
        theta_ok = all(np.all(np.isfinite(t)) for t in res.thetas) \
            and np.all(np.isfinite(res.ebic))
        truth_f1 = res.edge_metrics(g_field.edges)
        gate(theta_ok and nl == it and nl >= pit > 0 and pit >= rounds
             and pc == 0 and res.candidate_edges == g_cand.edges,
             f"select field_ising 64x64 n=16384 knn k=8 (default depth: "
             f"{spec.n_lambdas} lambdas x {spec.admm_rounds} rounds): "
             f"{len(res.candidate_edges)} candidates (buckets {buckets}), "
             f"{rounds} ADMM rounds; Newton launches {nl} = iterations {it} "
             f"(prox {pit}); plain calls on CUDA tensors {pc}; candidates "
             f"as screened above {res.candidate_edges == g_cand.edges}; F1 "
             f"against "
             f"the grid {truth_f1['f1']:.3f} (|support| {len(res.support)}, "
             f"lambda {res.lambda_selected:.4g})")
        warm, wall_w, nl, it, pit_w, rounds_w, pc = counted(
            lambda: sess.select(Xb))
        gate(warm.new_compiles == 0 and nl == it and pc == 0
             and np.all(np.isfinite(warm.ebic)),
             f"select field_ising on fresh same-shape data: new_compiles "
             f"{warm.new_compiles}, Newton launches {nl} = iterations {it}")
        print(f"  select field_ising wall (default depth, unprofiled): cold "
              f"{cold:.3f} s ({rounds} ADMM rounds), warm {wall_w:.3f} s "
              f"({rounds_w} ADMM rounds, {pit_w} prox Newton iterations); "
              f"comm scalars {warm.comm_scalars}", flush=True)
        del res, warm

        # a profiled select, and the kernel select against the plain one,
        # both cut in depth (printed): a profile of the default depth's
        # launches takes minutes to read back
        cut = A.StructureSpec(policy="knn", knn_k=8, **FIELD_SELECT_CUTS)
        cuts = ", ".join(f"{k} {v}" for k, v in FIELD_SELECT_CUTS.items())
        kern, _ = marked_profile(
            torch, f"select field_ising (cuts: {cuts})",
            lambda: sess.select(Xb, spec=cut), bmod, "_bucket_design",
            "bucket design", "builds")
        t0 = time.perf_counter()
        plain = sess.select(Xb, spec=cut, use_kernel=False)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        eb = float(np.max(np.abs(kern.ebic - plain.ebic)
                          / np.abs(plain.ebic)))
        gate(kern.support == plain.support
             and kern.lambda_selected == plain.lambda_selected
             and eb <= GATE_EBIC,
             f"select field_ising (cuts: {cuts}): kernel vs plain: same "
             f"support {kern.support == plain.support} (|support| "
             f"{len(kern.support)} / {len(plain.support)}), same lambda "
             f"{kern.lambda_selected:.5g} / {plain.lambda_selected:.5g}, "
             f"EBIC rel {eb:.2e}; plain wall {wall_p:.3f} s")
        del sess, kern, plain
    finally:
        bmod.bucket_newton_stats_op = newton_op
        ssolver.prox_update_flat = prox
    torch.cuda.empty_cache()


def phase11(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, check_newton, covered):
    """The paper's experiments from the port's own samplers, on the card:
    the sampler law, Fig. 2's exact oracles, Fig. 4 at paper size and the
    deployment-scale draws, every local fit through the Newton kernel and
    every pseudo-score through the score kernel; the Newton kernel held
    against its plain version (phase 3's check) at every bucket shape of
    this phase that no earlier check covered."""
    import repro_torch.core as C
    from repro_torch.core.batched import _bucket_design
    from repro_torch.stream.online import pseudo_score

    t_phase = time.perf_counter()
    print(f"phase 11: the paper's experiments from the port's own samplers "
          f"({smi})", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20120627)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(fn):
        """fn() on the kernel path, every count set to 0 just before and
        read just after: (result, wall s, Newton launches, score launches,
        plain calls on CUDA tensors)."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        out, wall = timed(fn)
        nl = nmod.bucket_newton_stats.launches
        sl = kmod.cl_score_channels.launches
        launches["newton"] += nl
        launches["score_c1"] += sl
        return out, wall, nl, sl, plain_cuda_calls["n"]

    def cover(tag, sess, X, tf):
        """Phase 3's kernel-against-plain check (GATE_STATS, a bitwise
        repeat) at each bucket of this fit whose shape none has had."""
        g, inc = sess.graph, sess.plan.include_singleton
        node_tf = (torch.zeros(g.p, device=dev) if tf is None
                   else tf.to(dev, torch.float32)[: g.p])[:, None]
        for b in sess.buckets:
            nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
            nbrs = torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev)
            mask = torch.as_tensor(b.mask, device=dev)
            Zb, xi, base, _ = _bucket_design(sess.family, X, nodes, nbrs,
                                             mask, node_tf[nodes], inc)
            if ("ising", tuple(Zb.shape), False) in covered:
                continue
            k, Cb, d, n = Zb.shape
            W = 0.05 * torch.randn((k, d * Cb), generator=gen, device=dev)
            check_newton(f"{tag} bucket d={d} k={k} n={n} singletons={inc}",
                         "ising", Zb, base, xi, W, None)

    #: the phase's kernel-path calls: fits, Newton launches and iterations,
    #: score norms and launches, and the calls that broke a count
    tally = {"fits": 0, "newton": 0, "iters": 0, "scores": 0,
             "score_launches": 0, "broken": 0}

    def local_fits(tag, g, X, include_singleton=True, tf=None):
        """fit_all_local through the Newton kernel, its launch counts (at
        least one launch per bucket per Newton iteration, no plain version
        on a CUDA tensor) and the uncovered bucket shapes."""
        fits, wall, nl, _, pc = counted(
            lambda: C.fit_all_local(g, X, include_singleton, tf))
        sess = A.Plan(graph=g, include_singleton=include_singleton).session()
        iters = {}
        sess.fit_local(X, iters=iters, theta_fixed=tf)
        tally["fits"] += 1
        tally["newton"] += nl
        tally["iters"] += sum(iters.values())
        if not (nl >= sum(iters.values()) and pc == 0):
            tally["broken"] += 1
            gate(False, f"{tag}: Newton launches {nl} for Newton iterations "
                 f"{iters}, plain calls on CUDA tensors {pc}")
        cover(tag, sess, X, tf)
        return fits, wall, sess

    def moment_err(fam, g, theta, X):
        mu = fam.exact_moments(g, theta)
        emp = fam.suff_stats(g, X.double()).mean(0).cpu().numpy()
        return float(np.max(np.abs(emp - mu)) * np.sqrt(X.shape[0]))

    # ---- the sampler law on the card -----------------------------------
    n, chains = SAMPLER_N, SAMPLER_CHAINS
    g3 = C.grid_graph(3, 3)
    m3 = C.random_model(g3, 0.4, 0.3, gen)
    draws = [("exact_sample", C.ISING, g3, m3.theta,
              lambda: C.exact_sample(m3, n, gen))]
    for method in ("sequential", "chromatic"):
        draws.append((f"gibbs_sample {method}", C.ISING, g3, m3.theta,
                      lambda method=method: C.gibbs_sample(
                          m3, n, gen, burnin=300, thin=3, n_chains=chains,
                          method=method)))
    for fam in (C.ISING, C.GAUSSIAN, C.POTTS3):
        g = C.grid_graph(2, 3) if fam is C.POTTS3 else g3
        th = fam.random_params(g, gen)
        draws.append((f"gibbs_sample_family {fam.name}", fam, g, th,
                      lambda fam=fam, g=g, th=th: C.gibbs_sample_family(
                          fam, g, th, n, gen, burnin=300, thin=3,
                          n_chains=chains)))
    for tag, fam, g, th, draw in draws:
        X, secs = timed(draw)
        err, tol = moment_err(fam, g, th, X), MOMENT_TOL[fam.name]
        gate(X.is_cuda and X.shape == (n, g.p) and err < tol,
             f"{tag}: {n} rows on a {g.p}-node grid ({chains} chains; "
             f"burnin 300, thin 3): max |mean u - E u| {err:.3f}/sqrt(n) "
             f"(gate {tol}); draw {secs:.3f} s")

    # ---- Fig. 2: exact oracles on a 12-node star ------------------------
    gs = C.star_graph(12)
    ms = C.random_model(gs, 0.5, 0.5, gen)

    def oracles(m):
        locs = C.exact_locals(m, include_singleton=False)
        trs = {sch: C.exact_consensus_variance(m, locs, sch, False)[0]
               for sch in PAPER_COMBINERS}
        trs["joint"] = C.exact_joint_mple_variance(m, False)[0]
        return locs, trs, C.exact_mle_variance(m, False)[0]

    (locs, trs, tr_mle), secs = timed(lambda: oracles(ms))
    _, warm = timed(lambda: oracles(ms))
    (locs_c, trs_c, tr_mle_c), secs_c = timed(
        lambda: oracles(C.IsingModel(gs, ms.theta.cpu())))
    d_loc = max(float(np.max(np.abs(getattr(a, f) - getattr(b, f))))
                for a, b in zip(locs, locs_c) for f in ("H", "V", "S"))
    d_tr = max([abs(trs[k] - trs_c[k]) for k in trs] + [abs(tr_mle
                                                            - tr_mle_c)])
    gate(d_loc <= GATE_ORACLE and d_tr <= GATE_ORACLE,
         f"fig2 star p=12 exact oracles on the card vs the CPU: H/V/S max "
         f"diff {d_loc:.2e}, traces {d_tr:.2e} (gate {GATE_ORACLE}); card "
         f"{secs:.3f} s first, {warm:.3f} s again, CPU {secs_c:.3f} s")
    gate(all(tr >= tr_mle * (1 - 1e-4) for tr in trs.values()),
         "fig2 no scheme below the MLE's trace (the Cramer-Rao floor): "
         "efficiency " + ", ".join(f"{k} {v / tr_mle:.4f}"
                                   for k, v in trs.items()))
    Xs = C.exact_sample(ms, 4000, gen)
    tf = ms.theta
    fits, wall, sess = local_fits("fig2 star", gs, Xs, False, tf)
    plain = sess.fit_local(Xs, use_kernel=False, theta_fixed=tf)
    dth = max(float(np.max(np.abs(a.theta - b.theta)))
              for a, b in zip(fits, plain))
    truth = tf.cpu().numpy()
    free = C.free_indices(gs, include_singleton=False)
    emp = {sch: 4000 * C.mse(C.combine(gs, fits, sch, False, truth), truth,
                             free) / tr_mle for sch in PAPER_COMBINERS}
    gate(dth <= GATE_THETA,
         f"fig2 star n=4000 (exact_sample): kernel vs plain local theta max "
         f"diff {dth:.2e}; fit_all_local {wall:.3f} s; one draw's n MSE / "
         f"tr V_mle " + ", ".join(f"{k} {v:.3f}" for k, v in emp.items()))

    # ---- Fig. 4 at paper size ------------------------------------------
    print(f"  fig4 replicates cut to {FIG4_CUT['models']} models x "
          f"{FIG4_CUT['sets']} sets (fig4_large.py quick-mode counts; paper "
          f"size 5 x 10)", flush=True)
    for gname, g in (("euclidean", C.euclidean_graph(100, 0.15, seed=0)),
                     ("scalefree", C.scale_free_graph(100, m=1, seed=0))):
        models = [C.random_model(g, 0.5, 0.5, gen)
                  for _ in range(FIG4_CUT["models"])]
        mean_mse, finite, worst = {}, True, 0.0
        for n in FIG4_NS:
            acc = {s: [] for s in PAPER_COMBINERS + ("joint",)}
            secs = {"draw": 0.0, "fit_all_local": 0.0, "fit_mple": 0.0}
            for m in models:
                truth = m.theta.cpu().numpy()
                for _ in range(FIG4_CUT["sets"]):
                    X, t = timed(lambda: C.gibbs_sample(
                        m, n, gen, burnin=150, thin=2, method="auto"))
                    secs["draw"] += t
                    fits, t, _ = local_fits(f"fig4 {gname} n={n}", g, X)
                    secs["fit_all_local"] += t
                    for sch in PAPER_COMBINERS:
                        acc[sch].append(C.mse(C.combine(g, fits, sch),
                                              truth))
                    # float64: in float32 the 1e-8 ridge vanishes against
                    # O(1) curvature, and two adjacent nodes frozen in all
                    # n rows (seen at n = 250) make H exactly singular
                    th, t = timed(lambda: C.fit_mple(g, X.double(),
                                                     n_iter=25))
                    secs["fit_mple"] += t
                    acc["joint"].append(C.mse(th, truth))
                    if n == FIG4_NS[-1]:
                        gs_, _, _, sl, pc = counted(
                            lambda: pseudo_score(g, th, X, n))
                        worst = max(worst, float(np.max(np.abs(gs_))))
                        tally["scores"] += 1
                        tally["score_launches"] += sl
                        if sl != 1 or pc:
                            tally["broken"] += 1
                            gate(False, f"fig4 {gname}: score launches "
                                 f"{sl} per pseudo-score, plain calls on "
                                 f"CUDA tensors {pc}")
            mean_mse[n] = {s: float(np.mean(v)) for s, v in acc.items()}
            finite &= all(np.all(np.isfinite(v)) for v in acc.values())
            reps = FIG4_CUT["models"] * FIG4_CUT["sets"]
            print(f"  fig4 {gname} n={n}: mean MSE "
                  + ", ".join(f"{s} {v:.4f}" for s, v in
                              mean_mse[n].items())
                  + "; per replicate " + ", ".join(
                      f"{k} {v / reps:.3f} s" for k, v in secs.items()),
                  flush=True)
        lo, hi = mean_mse[FIG4_NS[0]]["diagonal"], \
            mean_mse[FIG4_NS[-1]]["diagonal"]
        gate(finite and hi < lo and worst < GATE_STATIONARY,
             f"fig4 {gname}: every MSE finite {finite}; diagonal mean MSE "
             f"n={FIG4_NS[0]} {lo:.4f} > n={FIG4_NS[-1]} {hi:.4f}; max "
             f"|pseudo-score| at fit_mple's estimate (score kernel) "
             f"{worst:.2e} < {GATE_STATIONARY}")

    # ---- deployment scale: chromatic draws on the 64 x 64 grid ---------
    gf = C.grid_graph(64, 64)
    mf = C.random_model(gf, 0.5, 0.5, gen)
    truth = mf.theta.cpu().numpy()
    sess = A.Plan(graph=gf, combiners=("diagonal",)).session()
    field = {}
    for n in FIELD_DRAW_NS:
        X, secs = timed(lambda: C.chromatic_gibbs_sample(
            mf, n, gen, n_chains=FIELD_DRAW_CHAINS))
        res, wall, nl, sl, pc = counted(lambda: sess.fit(X))
        iters = {}
        sess.fit_local(X, iters=iters)
        tally["fits"] += 1
        tally["newton"] += nl
        tally["iters"] += sum(iters.values())
        tally["scores"] += 1
        tally["score_launches"] += sl
        tally["broken"] += not (nl >= sum(iters.values()) and sl == 1
                                and pc == 0)
        d = res.combined["diagonal"] - truth
        field[n] = (X, res, float(d @ d))
        gate(nl >= sum(iters.values()) and sl == 1 and pc == 0
             and np.all(np.isfinite(res.theta)),
             f"field chromatic_gibbs_sample n={n} ({FIELD_DRAW_CHAINS} "
             f"chains, burnin 200, thin 5): draw {secs:.3f} s; fit {wall:.3f}"
             f" s, Newton launches {nl} for iterations {iters}, score {sl}, "
             f"plain calls on CUDA tensors {pc}; diagonal MSE {d @ d:.4f}")
        cover("field", sess, X, None)
    device_profile(torch, f"chromatic draw n={FIELD_DRAW_NS[0]}",
                   lambda: C.chromatic_gibbs_sample(
                       mf, FIELD_DRAW_NS[0], gen,
                       n_chains=FIELD_DRAW_CHAINS))
    X, res, _ = field[FIELD_DRAW_NS[-1]]
    plain = sess.fit(X, use_kernel=False)
    dth = float(np.max(np.abs(res.combined["diagonal"]
                              - plain.combined["diagonal"])))
    lo, hi = field[FIELD_DRAW_NS[0]][2], field[FIELD_DRAW_NS[-1]][2]
    gate(dth <= GATE_THETA and hi < lo,
         f"field: kernel vs plain combined theta max diff {dth:.2e}; "
         f"diagonal MSE n={FIELD_DRAW_NS[0]} {lo:.4f} > "
         f"n={FIELD_DRAW_NS[-1]} {hi:.4f}")
    del field, X, res, plain
    torch.cuda.empty_cache()
    gate(tally["broken"] == 0 and tally["newton"] >= tally["iters"] > 0
         and tally["score_launches"] == tally["scores"] > 0,
         f"phase 11 launches: Newton {tally['newton']} over {tally['fits']} "
         f"local fits ({tally['iters']} bucket Newton iterations), score "
         f"{tally['score_launches']} over {tally['scores']} pseudo-scores; "
         f"calls with a broken count {tally['broken']}")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase12(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, g_eu, X_eu, g_field, X_field, check_newton, covered):
    """Parameter drift, durable stream checkpoints and a family without a
    fused-kernel epilogue, on the card: the hostile star's save and restore
    across its change-point, with the Newton kernel held against its plain
    version (phase 3's check) at every bucket shape of those runs that no
    earlier check covered; a drifting Gaussian field through the Newton
    and score kernels against the plain versions; and an epilogue-less
    Ising family's fit (closed-form hooks, autodiff score) against the
    registered Ising's kernel fit."""
    import dataclasses
    import functools
    import tempfile

    import repro_torch.checkpoint as CK
    import repro_torch.core as C
    import repro_torch.core.batched as bmod
    from repro_torch.core.families import (GAUSSIAN, IsingFamily,
                                           register_family)
    from repro_torch.stream import (ArrivalSpec, ByzantineSpec, CrashSpec,
                                    DriftSpec, FaultPlan, NetworkConfig,
                                    ReplaySpec, StreamSimulator)

    t_phase = time.perf_counter()
    print(f"phase 12: drift, stream checkpoints and an epilogue-less family "
          f"({smi})", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20120628)

    def counted(fn):
        """fn() on the kernel path, every count set to 0 just before and
        read just after: (result, wall s, Newton launches, score launches,
        plain calls on CUDA tensors)."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl = nmod.bucket_newton_stats.launches
        sl = kmod.cl_score_channels.launches
        launches["newton"] += nl
        launches["score_c1"] += sl
        return out, wall, nl, sl, plain_cuda_calls["n"]

    # ---- the hostile star: crash, Byzantine, replay and drift at once ---
    star = C.star_graph(6)
    model = C.random_model(star, 0.5, 0.4, gen, device=dev)
    ts = model.theta.cpu().numpy()
    pool = C.exact_sample(model, 900, gen)
    hostile = FaultPlan(
        crashes=(CrashSpec(node=2, at=3, restart_at=8),),
        byzantine=(ByzantineSpec(node=5, kind="scaled_noise", scale=1.0),),
        replay=ReplaySpec(prob=0.4, delay=2),
        drift=(DriftSpec(at=7, scale=0.3),))

    def hostile_sim(**over):
        kw = dict(scheme="diagonal", theta_star=ts,
                  network=NetworkConfig(drop_prob=0.4, delay=1, jitter=1),
                  arrivals=ArrivalSpec(kind="poisson", rate=30.0),
                  capacity=128, seed=11, faults=hostile, window=400)
        kw.update(over)
        return StreamSimulator(star, pool, **kw)

    newton_op = bmod.bucket_newton_stats_op
    seen = {}   # (kind, design shape, weighted) -> that shape's last inputs
    w_gen = torch.Generator(device=dev)     # the checks' W, apart from gen
    w_gen.manual_seed(20120629)

    def capturing(kind, Zb, base, xi, W, sw=None, **kw):
        key = (kind, tuple(Zb.shape), sw is not None)
        if Zb.is_cuda and key not in covered:
            seen[key] = tuple(None if t is None else t.detach().clone()
                              for t in (Zb, base, xi, W, sw))
        return newton_op(kind, Zb, base, xi, W, sw, **kw)

    (ROOT / "build").mkdir(exist_ok=True)
    for label, over in (("one_step", {}),
                        ("admm", dict(estimator="admm", newton_iters=8))):
        full = hostile_sim(**over)
        seen.clear()
        bmod.bucket_newton_stats_op = capturing
        try:
            res_full, wall, nl, _, pc = counted(
                lambda: full.run(HOSTILE_ROUNDS))
        finally:
            bmod.bucket_newton_stats_op = newton_op
        for (kind, shape, weighted), (Zb, base, xi, W_run, sw) in sorted(
                seen.items()):
            k, Cb, d, n = shape
            tag = (f"hostile star {label} bucket k={k} d={d} n={n} "
                   f"weighted={weighted}")
            # at the run's own converged iterate g cancels to near 0, so
            # its relative error says nothing: shown, and the check itself
            # draws W as phase 11's does
            g1, K1 = nmod.bucket_newton_stats(kind, Zb, base, xi, W_run, sw)
            g0, K0 = nmod.bucket_newton_stats_ref(kind, Zb, base, xi, W_run,
                                                  sw)
            print(f"  {tag}: at the run's last iterate |g| "
                  f"{float(g0.norm()):.2e}, |kernel - plain| "
                  f"{float((g1 - g0).norm()):.2e}, K rel "
                  f"{rel_err(K1, K0):.2e}", flush=True)
            W = 0.05 * torch.randn((k, d * Cb), generator=w_gen,
                                   device=dev)
            check_newton(tag, kind, Zb, base, xi, W, sw)
        print(f"  hostile star {label}: the Newton kernel held against its "
              f"plain version at {len(seen)} bucket shapes no earlier check "
              f"covered", flush=True)
        part = hostile_sim(**over)
        part.run(HOSTILE_SAVE)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            CK.save_stream(d, HOSTILE_SAVE, part)
            fresh = CK.restore_stream(d, hostile_sim(**over))
        rest = fresh.run(HOSTILE_ROUNDS - HOSTILE_SAVE)
        diff = max(
            max(float(np.max(np.abs(rest.estimate_at(t)
                                    - res_full.estimate_at(t))))
                for t in range(HOSTILE_SAVE + 1, HOSTILE_ROUNDS + 1)),
            float(np.max(np.abs(rest.err - res_full.err[HOSTILE_SAVE:]))))
        same_net = fresh.net.counters_dict() == full.net.counters_dict()
        gate(diff <= GATE_RESTORE and same_net
             and bool(np.all(np.isfinite(res_full.err))) and nl >= 1
             and pc == 0,
             f"hostile star {label}: save_stream at round {HOSTILE_SAVE}, "
             f"restore_stream into a fresh simulator, rounds "
             f"{HOSTILE_SAVE + 1}..{HOSTILE_ROUNDS} against the "
             f"uninterrupted run: largest difference {diff:.3e} (estimates "
             f"and err), network counters equal {same_net}; {nl} Newton "
             f"launches in {wall:.3f} s")
        again = hostile_sim(**over).run(HOSTILE_ROUNDS)
        gate(np.array_equal(again.theta, res_full.theta)
             and np.array_equal(again.err, res_full.err),
             f"hostile star {label}: two same-seed runs bitwise equal; MSE "
             f"round 7 {res_full.err[6]:.4f} -> round 8 (drifted) "
             f"{res_full.err[7]:.4f} -> round 12 {res_full.err[-1]:.4f}")
        del full, part, fresh

    # ---- field drift: a Gaussian MRF on the 64 x 64 grid ----------------
    t0 = time.perf_counter()
    theta = GAUSSIAN.random_params(g_field, gen, device=dev)
    pool_g = GAUSSIAN.exact_sample(g_field, theta, 16384, gen)
    torch.cuda.synchronize()
    print(f"  field pool: 16384 exact rows of a {g_field.p}-node Gaussian "
          f"MRF in {time.perf_counter() - t0:.2f} s", flush=True)
    theta0 = theta.cpu().numpy()
    plan_g = A.Plan(graph=g_field, family="gaussian",
                    combiners=("diagonal",),
                    faults=FaultPlan(drift=(DriftSpec(at=DRIFT_AT,
                                                      scale=DRIFT_SCALE),)),
                    stream_window=DRIFT_WINDOW)
    sess_g = plan_g.session()

    def field_sim():
        return sess_g.simulate(pool_g, theta_star=theta0,
                               arrivals=ArrivalSpec(rate=DRIFT_RATE))

    def min_eig(th):
        J = torch.as_tensor(GAUSSIAN._precision(g_field, th), device=dev)
        return float(torch.linalg.eigvalsh(J)[0])

    sim = field_sim()
    drift_s = {}
    apply_drift = sim._apply_drift

    def timed_drift(spec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply_drift(spec)
        torch.cuda.synchronize()
        drift_s["wall"] = time.perf_counter() - t0

    sim._apply_drift = timed_drift
    walls, errs, thetas, newton, scores, clean = [], [], [], [], [], True
    fed = None
    for r in range(DRIFT_ROUNDS):
        if r == DRIFT_AT:
            fed = sim._fed
        res, wall, nl, sl, pc = counted(
            lambda: sim.run(1, record_score=True))
        walls.append(wall)
        errs.append(float(res.err[-1]))
        thetas.append(res.theta[-1])
        newton.append(nl)
        scores.append(sl)
        clean &= nl >= 1 and sl == 1 and pc == 0 \
            and bool(np.isfinite(res.score_norm[-1]))
    moved = np.flatnonzero(sim.theta_star != theta0)
    n_tail = len(pool_g) - fed
    redrawn = not torch.equal(sim.pool[fed:], pool_g[fed:])
    gate(torch.equal(sim.pool[:fed], pool_g[:fed]) and redrawn
         and 0 < len(moved) and set(moved.tolist()) <= set(
             sim.free.tolist()),
         f"field drift at round {DRIFT_AT}: the {fed} rows fed before it "
         f"unchanged bitwise, the {n_tail} unseen rows re-drawn {redrawn}; "
         f"theta_star moved at {len(moved)} of {len(sim.free)} free "
         f"coordinates and nowhere else")
    eig0, eig1 = min_eig(theta0), min_eig(sim.theta_star)
    t0 = time.perf_counter()
    drifted = GAUSSIAN.moments(g_field, sim.theta_star)
    t_moments = time.perf_counter() - t0
    e = np.asarray(g_field.edges)
    ei = torch.as_tensor(e, device=dev)

    def law(mu, Sigma):
        """The exact means and edge second moments, and their variances."""
        i, j = e[:, 0], e[:, 1]
        exact = np.concatenate([mu, Sigma[i, j] + mu[i] * mu[j]])
        var = np.concatenate([
            np.diag(Sigma),
            Sigma[i, i] * Sigma[j, j] + Sigma[i, j] ** 2
            + mu[i] ** 2 * Sigma[j, j] + mu[j] ** 2 * Sigma[i, i]
            + 2 * mu[i] * mu[j] * Sigma[i, j]])
        return exact, var

    def empirical(rows):
        rows = rows.double()
        return torch.cat([rows.mean(0), (rows[:, ei[:, 0]]
                                         * rows[:, ei[:, 1]]).mean(0)]
                         ).cpu().numpy()

    def misfit(emp, exact_var):
        """(max |empirical - exact| sqrt(n), the mean of the squared
        standardised errors)."""
        exact, var = exact_var
        z = (emp - exact) * np.sqrt(n_tail)
        return float(np.max(np.abs(z))), float(np.mean(z ** 2 / var))

    law1 = law(*drifted)
    law0 = law(*GAUSSIAN.moments(g_field, theta0))
    emp_new = empirical(sim.pool[fed:])
    emp_old = empirical(pool_g[fed:])
    fit = misfit(emp_new, law1)
    ctl_old, ctl_law = misfit(emp_old, law1), misfit(emp_new, law0)
    shift = float(np.mean((law1[0] - law0[0]) ** 2 * n_tail / law1[1]))
    sd = float(np.sqrt(law1[1].max()))
    gate(eig1 > 0 and fit[0] <= MOMENT_TOL["gaussian"]
         and fit[1] <= GATE_TAIL_Z2 < min(ctl_old[1], ctl_law[1]),
         f"field drift: smallest eigenvalue of I - T {eig0:.4f} before the "
         f"jump, {eig1:.4f} after; the {n_tail} re-drawn rows' means and "
         f"edge second moments against the drifted exact moments: max "
         f"{fit[0]:.3f} / sqrt(n) (gate {MOMENT_TOL['gaussian']}, the "
         f"Gaussian conformance tolerance; largest standard deviation "
         f"{sd:.3f}; controls: the original tail against the drifted law "
         f"{ctl_old[0]:.3f}, the re-drawn tail against the undrifted law "
         f"{ctl_law[0]:.3f}), mean squared standardised error {fit[1]:.4f} "
         f"(gate {GATE_TAIL_Z2}; controls {ctl_old[1]:.4f} and "
         f"{ctl_law[1]:.4f}, above the gate; the jump's exact shift "
         f"{shift:.4f})")
    del emp_new, emp_old
    gate(clean and bool(np.all(np.isfinite(errs))),
         f"field drift: Newton launches per round {newton}, one score "
         f"launch per recorded round, no plain version on a CUDA tensor, "
         f"every err finite")
    print(f"  field drift: drift step wall {drift_s['wall']:.3f} s (host "
          f"moments {t_moments:.3f} s, timed alone after the run; the "
          f"Cholesky and the draw the rest), in a round of "
          f"{walls[DRIFT_AT]:.3f} s; median round wall "
          f"{statistics.median(walls):.4f} s (range {min(walls):.4f}-"
          f"{max(walls):.4f}); MSE round {DRIFT_AT} {errs[DRIFT_AT - 1]:.4f}"
          f" -> round {DRIFT_AT + 1} (drifted truth) {errs[DRIFT_AT]:.4f} "
          f"-> round {DRIFT_ROUNDS} {errs[-1]:.4f}; Newton launches "
          f"{sum(newton)}, score launches {sum(scores)}", flush=True)
    del sim
    sim_p = field_sim()
    sim_p.est.refit = functools.partial(sim_p.est.refit, use_kernel=False)
    sim_p.est.score_norm = functools.partial(sim_p.est.score_norm,
                                             use_kernel=False)
    plain_cuda_calls["n"] = 0
    t0 = time.perf_counter()
    res_p = sim_p.run(DRIFT_ROUNDS, record_score=True)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    dth = float(np.max(np.abs(res_p.theta - np.stack(thetas))))
    derr = float(np.max(np.abs(res_p.err - np.asarray(errs))))
    gate(dth <= GATE_TRAJECTORY and derr <= GATE_TRAJECTORY
         and plain_cuda_calls["n"] > 0,
         f"field drift with use_kernel=False: trajectory max diff {dth:.2e}"
         f", err max diff {derr:.2e} ({plain_cuda_calls['n']} plain calls, "
         f"{wall_p:.2f} s for {DRIFT_ROUNDS} rounds against "
         f"{sum(walls):.2f} s through the kernels)")
    del sim_p, res_p, pool_g
    torch.cuda.empty_cache()

    # ---- an Ising family registered without a fused epilogue ------------
    @dataclasses.dataclass(frozen=True)
    class PlainIsing(IsingFamily):
        name: str = "ising_plain"

        @property
        def kernel_kind(self):
            return None

    register_family(PlainIsing())
    for tag, g, X in (("euclidean p=100 n=4000", g_eu, X_eu),
                      (f"field p={g_field.p} n=16384", g_field,
                       X_field[:16384])):
        sess_k = A.Plan(graph=g, family="ising",
                        combiners=("diagonal",)).session()
        sess_p = A.Plan(graph=g, family="ising_plain",
                        combiners=("diagonal",)).session()
        cold_k = counted(lambda: sess_k.fit(X))[1]
        cold_p = counted(lambda: sess_p.fit(X))[1]
        rk, wall_k, nl_a, sl_k, pc_k = counted(lambda: sess_k.fit(X))
        rp, wall_p, nl_p, sl_p, pc_p = counted(lambda: sess_p.fit(X))
        _, _, nl_b, _, _ = counted(lambda: sess_k.fit(X))
        dth = max(float(np.max(np.abs(a.theta - b.theta)))
                  for a, b in zip(rk.fits, rp.fits))
        dth = max(dth, float(np.max(np.abs(rk.theta - rp.theta))))
        dscore = abs(rp.score_norm - rk.score_norm) / abs(rk.score_norm)
        gate(dth <= GATE_THETA and dscore <= 1e-4 and nl_p == 0
             and sl_p == 0 and pc_p == 0 and nl_a == nl_b >= 1
             and sl_k == 1 and pc_k == 0,
             f"epilogue-less Ising, {tag}: closed-form fit against the "
             f"registered Ising's kernel fit, theta max diff {dth:.2e}; "
             f"autodiff score norm {rp.score_norm:.6e} against the score "
             f"kernel's {rk.score_norm:.6e} (rel {dscore:.2e}); Newton "
             f"launches {nl_p} (kernel fits {nl_a}, {nl_b}), score launches "
             f"{sl_p}; warm fit wall {wall_p:.4f} s closed form against "
             f"{wall_k:.4f} s through the kernels (cold {cold_p:.3f} / "
             f"{cold_k:.3f} s)")
    torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase13(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, g_eu, X_eu, g_field, X_field, check_newton, covered):
    """The seed score entry points and telemetry on the card: every
    ``cl_score*`` entry, ``score_stats_op`` and ``family_score_stats``
    against the plain versions with one score launch per call; a warm field
    fit, joint and select at the structure bench's size and the hostile
    star with telemetry on, each bitwise equal to its telemetry-off run,
    with the Newton kernel held against its plain version (phase 3's check)
    at every bucket shape of those runs that no earlier check covered; the
    JSONL replay of the star's network ledger; a ``profile_dir`` trace."""
    import contextlib
    import tempfile

    import repro_torch.core as C
    import repro_torch.core.batched as bmod
    import repro_torch.kernels.cl as TK
    from repro_torch.kernels.cl import ref as rmod
    from repro_torch.stream import (ArrivalSpec, ByzantineSpec, CrashSpec,
                                    DriftSpec, FaultPlan, NetworkConfig,
                                    ReplaySpec, StreamSimulator)
    from repro_torch.telemetry import (TelemetrySpec, read_events,
                                       replay_network_counters)

    t_phase = time.perf_counter()
    print(f"phase 13: the seed score entry points and telemetry ({smi})",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20120630)
    tol32 = TK.precision_tolerance("float32")

    def counted(fn):
        """fn() on the kernel path, every count set to 0 just before and
        read just after: (result, wall s, Newton launches, score launches,
        plain calls on CUDA tensors)."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return (out, wall, nmod.bucket_newton_stats.launches,
                kmod.cl_score_channels.launches, plain_cuda_calls["n"])

    newton_op = bmod.bucket_newton_stats_op
    seen = {}   # (kind, design shape, weighted) -> that shape's last inputs
    w_gen = torch.Generator(device=dev)     # the checks' W, apart from gen
    w_gen.manual_seed(20120631)

    def capturing(kind, Zb, base, xi, W, sw=None, **kw):
        key = (kind, tuple(Zb.shape), sw is not None)
        if Zb.is_cuda and key not in covered:
            seen[key] = tuple(None if t is None else t.detach().clone()
                              for t in (Zb, base, xi, W, sw))
        return newton_op(kind, Zb, base, xi, W, sw, **kw)

    @contextlib.contextmanager
    def capture():
        """Keep the inputs of every Newton launch at a bucket shape no
        earlier check covered."""
        bmod.bucket_newton_stats_op = capturing
        try:
            yield
        finally:
            bmod.bucket_newton_stats_op = newton_op

    def hold_uncovered(label):
        """Phase 3's check at every captured shape, with W drawn as phase
        11's is: at a run's converged iterate g cancels to near 0."""
        n_shapes = len(seen)
        for (kind, shape, weighted), (Zb, base, xi, _, sw) in sorted(
                seen.items()):
            k, Cb, d, n = shape
            W = 0.05 * torch.randn((k, d * Cb), generator=w_gen, device=dev)
            check_newton(f"{label} bucket k={k} C={Cb} d={d} n={n} "
                         f"weighted={weighted}", kind, Zb, base, xi, W, sw)
        seen.clear()
        torch.cuda.empty_cache()
        print(f"  {label}: the Newton kernel held against its plain version "
              f"at {n_shapes} bucket shapes no earlier check covered",
              flush=True)

    # ---- (a) the entry points against their plain versions --------------
    def inputs(kind, n, p, Cd):
        if kind == "potts":
            x = torch.randint(0, Cd + 1, (n, p), generator=gen, device=dev)
            F = torch.stack([(x == c + 1).float() for c in range(Cd)])
        elif kind == "gaussian":
            F = torch.randn((1, n, p), generator=gen, device=dev)
        else:
            F = torch.where(torch.rand((1, n, p), generator=gen,
                                       device=dev) < .5, 1., -1.)
        th = 0.3 * torch.randn((Cd, p, p), generator=gen, device=dev)
        th = ((th + th.transpose(1, 2)) / 2).contiguous()
        mask = torch.triu((torch.rand((p, p), generator=gen, device=dev)
                           < .3).float(), 1)
        mask = (mask + mask.T).contiguous()
        bias = 0.1 * torch.randn((Cd, p), generator=gen, device=dev)
        return F, th, mask, bias

    #: calls made, the largest max-abs error at the conformance shapes and
    #: the largest relative errors (eta and r, S) elsewhere
    worst = {"calls": 0, "abs": 0.0, "elem": 0.0, "stats": 0.0}

    def check_entry(tag, call, want, n_live, conformance):
        """One entry-point call: one score launch, no plain version on a
        CUDA tensor, and its (eta, r, S) against the plain ``want``; a
        failing call prints its own FAIL line."""
        (eta, r, S), _, nl, sl, pc = counted(call)
        launches["score_c1" if eta.dim() == 2 or eta.shape[0] == 1
                 else "score_cn"] += sl
        worst["calls"] += 1
        if eta.dim() == 2:
            eta, r = eta[:n_live], r[:n_live]
        else:
            eta, r = eta[:, :n_live], r[:, :n_live]
        got = (eta, r, S)
        if conformance:
            err = max(abs_err(g, w) for g, w in zip(got, want))
            worst["abs"] = max(worst["abs"], err)
            ok = err <= tol32
            what = f"max abs {err:.2e} (tolerance {tol32:g})"
        else:
            ee, er, eS = (rel_err(g, w) for g, w in zip(got, want))
            worst["elem"] = max(worst["elem"], ee, er)
            worst["stats"] = max(worst["stats"], eS)
            ok = ee <= GATE_ELEM and er <= GATE_ELEM and eS <= GATE_STATS
            what = f"rel eta {ee:.2e} r {er:.2e} S {eS:.2e}"
        ok = ok and sl == 1 and nl == 0 and pc == 0
        if not ok:
            gate(False, f"entry {tag}: {what}; score launches {sl}, plain "
                 f"calls on CUDA tensors {pc}")
        return ok

    shapes = [(n, p, True) for n, p in ((32, 10), (130, 128), (200, 150),
                                        (5, 260))]
    shapes += [(4000, 100, False), (16384, 4096, False)]
    fails = 0
    for n_cap, p, conformance in shapes:
        # the last shape is the field grid's zero-padded buffer: capacity
        # 16384 holding 12288 rows; elsewhere the padded entries get a
        # buffer of twice the rows
        n_live = 12288 if n_cap == 16384 else n_cap
        cap = n_cap if n_cap == 16384 else 2 * n_cap
        for kind, Cd in (("ising", 1), ("gaussian", 1), ("potts", 2)):
            F, th, mask, bias = inputs(kind, n_live, p, Cd)
            F_pad = torch.zeros((Cd, cap, p), device=dev)
            F_pad[:, :n_live] = F
            calls = []
            if Cd == 1:
                x, x_pad, t1, b1 = F[0], F_pad[0], th[0], bias[0]
                want = rmod.cl_score_ref(x, t1, mask, b1, kind=kind)
                calls += [
                    ("cl_score", lambda: TK.cl_score(x, t1, mask, b1,
                                                     kind=kind)),
                    ("score_stats_op", lambda: TK.score_stats_op(
                        x, t1, mask, b1, kind=kind)),
                    ("cl_score_padded", lambda: TK.cl_score_padded(
                        x_pad, t1, mask, b1, n_live, kind=kind))]
                if kind == "ising":
                    calls += [
                        ("ising_cl_score", lambda: TK.ising_cl_score(
                            x, t1, mask, b1)),
                        ("ising_cl_score_padded",
                         lambda: TK.ising_cl_score_padded(
                             x_pad, t1, mask, b1, n_live))]
            else:
                want = rmod.cl_score_channels_ref(F, th, mask, bias, kind)
                try:
                    TK.cl_score(F[0], th[0], mask, bias[0], kind=kind)
                    refused = False
                except ValueError:
                    refused = True
                if not refused:
                    gate(False, f"cl_score accepted the multi-channel "
                         f"kind {kind}")
            calls.append(("cl_score_channels_padded",
                          lambda: TK.cl_score_channels_padded(
                              F_pad, th, mask, bias, n_live, kind=kind)))
            for name, call in calls:
                tag = f"{name} {kind} n={n_live} (buffer {cap}) p={p}"
                fails += not check_entry(tag, call, want, n_live,
                                         conformance)
            del F, th, mask, bias, F_pad, want
    # family_score_stats on the paper graph and the field's padded buffer
    fam_graphs = (("paper", g_eu, X_eu, X_eu.shape[0]),
                  ("field buffer", g_field, X_field[:16384], 12288))
    for label, g, X, n_live in fam_graphs:
        for name in ("ising", "gaussian", "potts"):
            fam = C.get_family(name)
            theta = (0.2 * torch.randn(fam.n_params(g), generator=gen,
                                       device=dev, dtype=torch.float64))
            if name == "ising":
                Xs = X.clone()
            elif name == "gaussian":
                Xs = torch.randn(X.shape, generator=gen, device=dev)
            else:
                Xs = torch.randint(0, 3, X.shape, generator=gen,
                                   device=dev).float()
            Xs[n_live:] = 0.0
            want = rmod.cl_score_channels_ref(
                *TK.family_kernel_inputs(fam, g, theta, Xs),
                fam.kernel_kind)
            fails += not check_entry(
                f"family_score_stats {name} {label} p={g.p}",
                lambda: TK.family_score_stats(fam, g, theta, Xs), want,
                Xs.shape[0], False)
            del Xs, want
    torch.cuda.empty_cache()
    gate(fails == 0, f"entry points: {worst['calls']} calls at the "
         f"conformance, paper and field-buffer shapes (ising, gaussian, "
         f"potts q=3), {fails} failed; each one score launch and no plain "
         f"version on a CUDA tensor; largest max-abs error at the "
         f"conformance shapes {worst['abs']:.2e} (tolerance {tol32:g}), "
         f"largest relative error elsewhere eta/r {worst['elem']:.2e}, S "
         f"{worst['stats']:.2e}")

    # ---- (b) warm field fit, telemetry on and off -----------------------
    Xf = X_field[:16384]
    plan = A.Plan(graph=g_field, family="ising", combiners=FIELD_COMBINERS)
    off = plan.session()
    on = plan.replace(telemetry=TelemetrySpec()).session()
    with capture():
        cold, _, nl_c, sl_c, _ = counted(lambda: on.fit(Xf))
    hold_uncovered("field fit")
    launches["newton"] += nl_c
    launches["score_c1"] += sl_c
    tags = [e for e in cold.telemetry.events if e["kind"] == "event"]
    walls = {"off": [], "on": []}
    runs = {}
    for _ in range(5):
        for key, sess in (("off", off), ("on", on)):
            res, wall, nl, sl, pc = counted(lambda: sess.fit(Xf))
            walls[key].append(wall)
            runs[key] = (res, nl, sl, pc)
            launches["newton"] += nl
            launches["score_c1"] += sl
    (r_off, nl_off, sl_off, _), (r_on, nl_on, sl_on, pc_on) = \
        runs["off"], runs["on"]
    same = (np.array_equal(r_off.theta, r_on.theta)
            and all(np.array_equal(r_off.combined[c], r_on.combined[c])
                    for c in FIELD_COMBINERS)
            and r_off.score_norm == r_on.score_norm)
    spans = set(r_on.telemetry.spans)
    warm_tags = [e for e in r_on.telemetry.events if e["kind"] == "event"]
    gate(same and (nl_off, sl_off) == (nl_on, sl_on) == (nl_c, sl_c)
         and pc_on == 0 and {"fit", "fit/bucket_solve", "fit/combine"}
         <= spans and tags and not warm_tags
         and all(e["tags"]["backend"] == "cuda" for e in tags)
         and r_off.telemetry is None,
         f"field warm fit with telemetry on against off: theta, combined "
         f"and score norm bitwise equal {same}; launches Newton {nl_on} / "
         f"{nl_off}, score {sl_on} / {sl_off} (cold {nl_c} / {sl_c}); "
         f"spans {sorted(spans)}; {len(tags)} kernel tags on the fresh "
         f"session's cold fit, backends "
         f"{sorted({e['tags']['backend'] for e in tags})}, {len(warm_tags)} "
         f"on the warm fit")
    print(f"  field warm fit median of 5: telemetry off "
          f"{statistics.median(walls['off']):.4f} s (range "
          f"{min(walls['off']):.4f}-{max(walls['off']):.4f}), on "
          f"{statistics.median(walls['on']):.4f} s (range "
          f"{min(walls['on']):.4f}-{max(walls['on']):.4f}); "
          f"{len(r_on.telemetry.events)} events per fit", flush=True)

    # ---- (c) joint and select at the structure bench's size -------------
    g_sb = C.grid_graph(5, 6)
    X_sb = planted_structure(torch, np, g_sb, "ising", 2000, gen, dev)
    plan = A.Plan(graph=g_sb, family="ising", combiners=("diagonal",))
    s_off = plan.session()
    s_on = plan.replace(telemetry=TelemetrySpec()).session()
    for verb, want_spans in (
            ("joint", {"joint", "joint/bucket_solve", "joint/admm_iter",
                       "joint/admm_iter/prox_bucket_solve"}),
            ("select", {"select", "select/screen", "select/dense_fit",
                        "select/dense_fit/bucket_solve", "select/path",
                        "select/path/prox_bucket_solve", "select/vote"})):
        # both runs keep their Newton inputs, so their walls compare
        with capture():
            a, wall_a, nl_a, sl_a, _ = counted(
                lambda: getattr(s_off, verb)(X_sb))
            b, wall_b, nl_b, sl_b, pc = counted(
                lambda: getattr(s_on, verb)(X_sb))
        hold_uncovered(f"{verb} on the 5 x 6 grid")
        launches["newton"] += nl_a + nl_b
        launches["score_c1"] += sl_a + sl_b
        if verb == "joint":
            same = (np.array_equal(a.trajectory, b.trajectory)
                    and a.score_norm == b.score_norm)
        else:
            same = (a.support == b.support and np.array_equal(a.ebic, b.ebic)
                    and all(np.array_equal(u, v)
                            for u, v in zip(a.thetas, b.thetas)))
        spans = {k: v["count"] for k, v in b.telemetry.spans.items()}
        gate(same and want_spans <= set(spans) and (nl_a, sl_a) ==
             (nl_b, sl_b) and pc == 0,
             f"{verb} on the 5 x 6 grid (n = 2000) with telemetry on "
             f"against off: outputs bitwise equal {same}; launches Newton "
             f"{nl_b} / {nl_a}, score {sl_b} / {sl_a}; spans {spans}; "
             f"wall {wall_b:.3f} s on, {wall_a:.3f} s off")

    # ---- (d) the hostile star with a JSONL log -------------------------
    star = C.star_graph(6)
    model = C.random_model(star, 0.5, 0.4, gen, device=dev)
    ts = model.theta.cpu().numpy()
    pool = C.exact_sample(model, 900, gen)
    hostile = FaultPlan(
        crashes=(CrashSpec(node=2, at=3, restart_at=8),),
        byzantine=(ByzantineSpec(node=5, kind="scaled_noise", scale=1.0),),
        replay=ReplaySpec(prob=0.4, delay=2),
        drift=(DriftSpec(at=7, scale=0.3),))

    def hostile_sim(**over):
        kw = dict(scheme="diagonal", theta_star=ts,
                  network=NetworkConfig(drop_prob=0.4, delay=1, jitter=1),
                  arrivals=ArrivalSpec(kind="poisson", rate=30.0),
                  capacity=128, seed=11, faults=hostile, window=400)
        kw.update(over)
        return StreamSimulator(star, pool, **kw)

    (ROOT / "build").mkdir(exist_ok=True)
    for label, over in (("one_step", {}),
                        ("admm", dict(estimator="admm", newton_iters=8))):
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
            path = str(Path(d) / "star.jsonl")
            sim = hostile_sim(telemetry=TelemetrySpec(jsonl=path), **over)
            with capture():
                res, wall_on, nl_b, _, pc = counted(
                    lambda: sim.run(HOSTILE_ROUNDS))
            replayed = replay_network_counters(read_events(path))
        with capture():
            plain, wall_off, nl_a, _, _ = counted(
                lambda: hostile_sim(**over).run(HOSTILE_ROUNDS))
        launches["newton"] += nl_a + nl_b
        hold_uncovered(f"hostile star {label}")
        live = sim.net.counters_dict()
        exact = (all(replayed[k] == v for k, v in live.items())
                 and replayed["in_flight"] == sim.net.in_flight
                 and replayed["scalars_in_flight"]
                 == sim.net.scalars_in_flight)
        tl = np.array_equal(res.timeline("err")[1], res.err)
        same = (np.array_equal(res.theta, plain.theta)
                and np.array_equal(res.err, plain.err)
                and np.array_equal(res.scalars_sent, plain.scalars_sent))
        gate(exact and tl and same and nl_a == nl_b >= 1 and pc == 0,
             f"hostile star {label} with a JSONL log: replayed network "
             f"ledger equal to the live counters {exact} ({live}); "
             f"timeline('err') equal to the recorded column {tl}; run "
             f"bitwise equal to the telemetry-off run {same}; Newton "
             f"launches {nl_b} / {nl_a}; {len(res.telemetry.events)} events,"
             f" wall {wall_on:.3f} s on, {wall_off:.3f} s off")

    # ---- (e) profile_dir -------------------------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        sess = A.Plan(graph=g_eu, family="ising",
                      telemetry=TelemetrySpec(profile_dir=d)).session()
        with capture():
            res, wall, nl, sl, _ = counted(lambda: sess.fit(X_eu))
        launches["newton"] += nl
        launches["score_c1"] += sl
        hold_uncovered("profile_dir paper fit")
        paths = sorted(Path(d).glob("*.pt.trace.json"))
        text = paths[0].read_text() if len(paths) == 1 else ""
        names = sorted({n for n in ("newton_narrow_kernel",
                                    "newton_wide_kernel",
                                    "masked_logits_kernel",
                                    "gram_tile_kernel") if n in text})
        gate(len(paths) == 1 and any("newton" in n for n in names)
             and any("newton" not in n for n in names) and nl >= 1
             and sl == 1,
             f"profile_dir: {len(paths)} trace file(s) "
             f"({len(text) / 1e6:.2f} MB) naming {names}; fit wall "
             f"{wall:.3f} s under the profiler")
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase14(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, dev,
            g_field, X_field, check_newton, time_newton, bucket_inputs,
            covered):
    """The multi-tenant session server on the card: the serve bench at its
    full size, coalesced and serial (its invariants: no rejection, no build
    when warm, coalesced throughput above serial; every coalesced ticket
    within GATE_COALESCE of the serial server's; fewer Newton launches
    coalesced), then eight field tenants' fit requests and stream rounds,
    coalesced into one union bucket of k = 32768 against eight serial
    dispatches, with the Newton kernel held against its plain version at
    the union bucket and timed there, and held at every other bucket shape
    the served runs send that no earlier check covered. Coalesced tickets
    are gated where every owner's serial fit is settled (COND_LIMIT,
    STEP_LIMIT); the difference over all parameters is printed beside
    it. Every served run counts its Newton statistics calls and kernel
    launches, which must be equal (one launch per bucket per Newton
    iteration for the whole group), and no plain version may see a CUDA
    tensor."""
    import repro_torch.core.batched as bmod
    from repro_torch.core import scale_free_graph
    from repro_torch.serve import (SessionServer, VirtualClock, run_load,
                                   synthetic_workload, union_graph)

    t_phase = time.perf_counter()
    print(f"phase 14: the session server ({smi})", flush=True)
    op = bmod.bucket_newton_stats_op
    tally = {"calls": 0, "weighted": 0}
    seen = {}      # (kind, design shape, weighted) -> that shape's inputs
    capturing = {"on": False}
    w_gen = torch.Generator(device=dev)
    w_gen.manual_seed(20120632)

    def counting(kind, Zb, base, xi, W, sw=None, **kw):
        tally["calls"] += 1
        tally["weighted"] += sw is not None
        key = (kind, tuple(Zb.shape), sw is not None)
        if capturing["on"] and Zb.is_cuda and key not in covered \
                and key not in seen:
            seen[key] = tuple(None if t is None else t.detach().clone()
                              for t in (Zb, base, xi, sw))
        return op(kind, Zb, base, xi, W, sw, **kw)

    def hold_captured(label):
        """Phase 3's check at every bucket shape captured since the last
        call (W drawn: at a converged iterate g cancels to near 0)."""
        for (kind, shape, weighted), (Zb, b_, xi, sw) in sorted(
                seen.items()):
            k, Cb, d, n = shape
            W = 0.05 * torch.randn((k, d * Cb), generator=w_gen, device=dev)
            check_newton(f"{label} bucket k={k} C={Cb} d={d} n={n} "
                         f"weighted={weighted}", kind, Zb, b_, xi, W, sw)
        print(f"  {label}: the Newton kernel held against its plain version "
              f"at {len(seen)} bucket shapes no earlier check covered",
              flush=True)
        seen.clear()
        torch.cuda.empty_cache()

    def counted(fn):
        """fn() with every count set to 0 just before and read just after:
        (result, wall s, Newton launches, statistics calls, weighted calls,
        plain calls on CUDA tensors); the launches join the kernels line."""
        nmod.bucket_newton_stats.launches = 0
        tally["calls"] = tally["weighted"] = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl = nmod.bucket_newton_stats.launches
        launches["newton"] += nl
        return (out, wall, nl, tally["calls"], tally["weighted"],
                plain_cuda_calls["n"])

    owner_rows = {}

    def owner_nodes(owners):
        """(n_params, 2) owner node ids of each parameter (-1 pads one)."""
        key = id(owners)
        if key not in owner_rows:
            rows = np.full((len(owners), 2), -1, dtype=np.int64)
            for a, own in owners.items():
                rows[a, :len(own)] = [i for i, _ in own]
            owner_rows[key] = (owners, rows)
        return owner_rows[key][1]

    def settled(plan, fits, X, sw=None):
        """Per node of a serial result, and True for the pad of one-owner
        rows: a finite local H with cond < COND_LIMIT, and a plain float64
        Newton step from the served estimate below STEP_LIMIT (one guarded
        iteration warm-started there on the rows the fit saw)."""
        good = np.zeros(len(fits) + 1, dtype=bool)
        good[-1] = True
        shapes = {}
        for i, f in enumerate(fits):
            if np.all(np.isfinite(f.H)):
                shapes.setdefault(f.H.shape, []).append(i)
        for idx in shapes.values():
            H = np.stack([fits[i].H for i in idx])
            good[idx] = np.linalg.cond(H) < COND_LIMIT
        one = plan.replace(n_iter=1, precision="float64").session()
        stepped = one.fit_local(X, sample_weight=sw,
                                warm_start=[f.theta for f in fits],
                                want_influence=False, use_kernel=False)
        for i, (f1, f) in enumerate(zip(stepped, fits)):
            good[i] &= bool(np.abs(f1.theta - f.theta).max() <= STEP_LIMIT)
        return good

    def close(a, b, owners, good):
        """(gated, over every parameter, parameters left out): the largest
        normwise relative difference of two served results over theta and
        every combined estimate, at the parameters whose owners are all
        ``good`` (from settled() of the serial result ``b``), then
        everywhere."""
        keep = good[owner_nodes(owners)].all(axis=1)

        def rel(x, y, m):
            x, y = np.asarray(x)[m], np.asarray(y)[m]
            return float(np.linalg.norm(x - y)
                         / max(float(np.linalg.norm(y)), 1e-30))
        pairs = [(a.theta, b.theta)]
        pairs += [(a.combined[c], b.combined[c]) for c in b.combined]
        every = np.ones_like(keep)
        return (max(rel(x, y, keep) for x, y in pairs),
                max(rel(x, y, every) for x, y in pairs), int((~keep).sum()))

    def worst_of(pairs, srv, rows):
        """close() over (coalesced, serial) ticket pairs, ``rows`` giving
        each serial ticket's (X, sample weights): the largest gated and
        overall differences and the parameters left out in all."""
        out = []
        for a, b in pairs:
            sess = srv.tenant(b.tenant_id).session
            good = settled(sess.plan, b.result.fits, *rows(b))
            out.append(close(a.result, b.result, sess.owners, good))
        return (max(o[0] for o in out), max(o[1] for o in out),
                sum(o[2] for o in out))

    bmod.bucket_newton_stats_op = counting
    try:
        # ---- (a) the serve bench at its full size ------------------------
        base = A.Plan(graph=scale_free_graph(24, seed=0), family="ising",
                      combiners=("diagonal",), n_iter=8)
        alt = base.replace(combiners=("uniform",))
        plans = {f"t{j:02d}": (base if j % 4 else alt)
                 for j in range(SERVE_TENANTS)}
        t0 = time.perf_counter()
        schedule = synthetic_workload(plans, rounds=SERVE_ROUNDS,
                                      n_rows=SERVE_ROWS, seed=0)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        X0 = schedule[0][0][1]
        print(f"  serve bench: {SERVE_TENANTS} tenants x {SERVE_ROUNDS} "
              f"rounds of {SERVE_ROWS} rows drawn by synthetic_workload("
              f"seed=0) on the card ({X0.device}, {X0.dtype}) in "
              f"{draw_s:.2f} s", flush=True)
        runs = {}
        for coalesce in (True, False):
            srv = SessionServer(coalesce=coalesce,
                                max_coalesce=SERVE_COALESCE,
                                clock=VirtualClock())
            for tid, plan in plans.items():
                srv.register(tid, plan)
            warm = run_load(srv, schedule[:1])
            capturing["on"] = True
            meas, wall, nl, calls, _, pc = counted(
                lambda: run_load(srv, schedule[1:]))
            capturing["on"] = False
            runs[coalesce] = (srv, warm, meas, nl, calls, pc)
            mode = "coalesced" if coalesce else "serial"
            s = meas.summary()
            snap = srv.metrics()
            tickets = warm.tickets + meas.tickets
            n_groups = len(snap.histograms["serve.coalesce_size"])
            reconciled = (
                snap.counter("serve.admitted") == len(tickets)
                == snap.counter("serve.served")
                and snap.counter("serve.rejected") == 0
                and snap.counter("serve.dispatches") == n_groups
                == snap.spans["serve_dispatch"]["count"]
                and sum(snap.histograms["serve.coalesce_size"])
                == len(tickets)
                and len(snap.histograms["serve.latency_s"]) == len(tickets))
            gate(meas.n_rejected == 0 and warm.n_rejected == 0
                 and meas.new_compiles == 0 and nl == calls and pc == 0
                 and reconciled,
                 f"serve bench {mode}: {s['n_served']} requests (warm-up "
                 f"round {warm.n_served}, {warm.wall_s:.3f} s), p50 "
                 f"{s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
                 f"{s['throughput_rps']:.1f} requests/s over "
                 f"{s['wall_s']:.3f} s, mean group "
                 f"{s['mean_coalesce_size']:.2f}, builds {meas.new_compiles}"
                 f", rejected "
                 f"{meas.n_rejected}; Newton launches {nl} "
                 f"({nl / max(s['n_served'], 1):.1f} a request) for {calls} "
                 f"statistics calls, plain calls on CUDA tensors {pc}; "
                 f"counters reconciled with {len(tickets)} tickets over "
                 f"{n_groups} dispatches {reconciled}")
        (_, _, meas_c, nl_c, _, _), (_, _, meas_s, nl_s, _, _) = \
            runs[True], runs[False]
        X_of = {}
        for t, (_, X, _) in zip(meas_s.tickets,
                                (r for rs in schedule[1:] for r in rs)):
            X_of[t.seq] = X
        worst, worst_all, left = worst_of(
            zip(meas_c.tickets, meas_s.tickets), runs[False][0],
            lambda t: (X_of[t.seq], None))
        same = all((a.tenant_id, a.seq, a.result.comm_scalars)
                   == (b.tenant_id, b.seq, b.result.comm_scalars)
                   for a, b in zip(meas_c.tickets, meas_s.tickets))
        gate(meas_c.throughput_rps > meas_s.throughput_rps
             and nl_c < nl_s and worst <= GATE_COALESCE and same,
             f"serve bench: coalesced {meas_c.throughput_rps:.1f} against "
             f"serial {meas_s.throughput_rps:.1f} requests/s (x"
             f"{meas_c.throughput_rps / meas_s.throughput_rps:.2f}); Newton "
             f"launches {nl_c} against {nl_s}; every coalesced ticket "
             f"within {worst:.2e} of the serial server's (gate "
             f"{GATE_COALESCE:g}) where every owner's fit is settled "
             f"(cond(H) < {COND_LIMIT:g}, Newton step < {STEP_LIMIT:g}; "
             f"{left} ticket parameters left out; {worst_all:.2e} over "
             f"all)")
        hold_captured("serve bench")
        del runs, schedule, meas_c, meas_s

        # ---- (b) field serving: eight tenants on the 64 x 64 grid --------
        fplan = A.Plan(graph=g_field, family="ising",
                       combiners=("diagonal",), capacity=FIELD_ROWS)
        blocks = [X_field[FIELD_ROWS * i: FIELD_ROWS * (i + 1)]
                  for i in range(X_field.shape[0] // FIELD_ROWS)]
        tids = [f"f{j}" for j in range(FIELD_TENANTS)]
        servers = {}
        for coalesce in (True, False):
            srv = SessionServer(coalesce=coalesce, max_coalesce=FIELD_TENANTS)
            for tid in tids:
                srv.register(tid, fplan)
            servers[coalesce] = srv

        def serve_round(srv, rows, kind):
            tickets = [srv.submit(tid, X, kind=kind)
                       for tid, X in zip(tids, rows)]
            out = counted(srv.drain)
            return (tickets,) + out[1:]

        fit_rows = blocks[:FIELD_TENANTS]
        # the Newton kernel at the union bucket, held and timed
        ug = union_graph(g_field, FIELD_TENANTS)
        X_union = torch.cat(fit_rows, 1)
        _, ub = bucket_inputs(ug, "ising", X_union, False)
        for deg_pad, args in ub:
            k, Cb, d, n = args[0].shape
            tag = f"serve field union bucket d={d} k={k} n={n}"
            check_newton(tag, "ising", *args)
            row = time_newton(tag, "ising", args, 10)
            print(f"  union bucket: kernel {row['ms']:.4f} ms against its "
                  f"byte bound {row['bound_ms']:.4f} ms; one launch per "
                  f"Newton iteration of a coalesced dispatch", flush=True)
        del ub, X_union
        torch.cuda.empty_cache()

        capturing["on"] = True
        for label in ("cold", "warm"):
            res = {c: serve_round(servers[c], fit_rows, "fit")
                   for c in (True, False)}
            (tc, wc, nlc, cc, _, pcc), (ts, ws, nls, cs, _, pcs) = \
                res[True], res[False]
            X_of = dict(zip((t.seq for t in ts), fit_rows))
            worst, worst_all, left = worst_of(
                zip(tc, ts), servers[False], lambda t: (X_of[t.seq], None))
            gate(all(t.result.coalesce_size == FIELD_TENANTS for t in tc)
                 and all(t.result.coalesce_size == 1 for t in ts)
                 and nlc == cc and nls == cs and pcc == pcs == 0
                 and worst <= GATE_COALESCE,
                 f"field fit {label}: {FIELD_TENANTS} tenants x "
                 f"{FIELD_ROWS} rows, coalesced {wc:.3f} s "
                 f"({wc / len(tc):.4f} s a request; {nlc} Newton launches) "
                 f"against serial "
                 f"{ws:.3f} s ({ws / len(ts):.4f} s a request; {nls} "
                 f"launches); coalesced within {worst:.2e} of serial where "
                 f"every owner's fit is settled ({left} of "
                 f"{len(tc) * tc[0].result.theta.size} parameters left out;"
                 f" {worst_all:.2e} over all)")

        def pool(t):
            """A serial stream ticket's tenant pool and fit weights."""
            est = servers[False].tenant(t.tenant_id).stream
            return est.buffer.tensor, est.buffer.window_weights(
                est.counts, est.window, est.discount)

        # stream rounds: rotated blocks, the cold round then warm rounds
        for rnd in range(FIELD_ROUNDS):
            rows = [blocks[(j + 3 * rnd) % len(blocks)]
                    for j in range(FIELD_TENANTS)]
            res = {c: serve_round(servers[c], rows, "stream")
                   for c in (True, False)}
            (tc, wc, nlc, cc, wtc, pcc), (ts, ws, nls, cs, wts, pcs) = \
                res[True], res[False]
            worst, worst_all, left = worst_of(zip(tc, ts), servers[False],
                                              pool)
            n_pool = (rnd + 1) * FIELD_ROWS
            gate(all(t.result.coalesce_size == FIELD_TENANTS
                     and t.result.n_samples == n_pool for t in tc)
                 and nlc == cc == wtc > 0 and nls == cs == wts > 0
                 and pcc == pcs == 0 and worst <= GATE_COALESCE,
                 f"field stream round {rnd} ({'cold' if rnd == 0 else 'warm'}"
                 f", pool {n_pool} rows): coalesced {wc:.3f} s "
                 f"({nlc} weighted Newton launches) against serial "
                 f"{ws:.3f} s ({nls}); coalesced within {worst:.2e} of "
                 f"serial where every owner's fit is settled ({left} "
                 f"parameters left out; {worst_all:.2e} over all)")
        capturing["on"] = False
        hold_captured("field serving")
        del servers
    finally:
        bmod.bucket_newton_stats_op = op
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s", flush=True)


def tree_items(tree, path=""):
    """('/'-joined path, tensor) pairs of nested dicts and NamedTuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from tree_items(getattr(tree, k), f"{path}/{k}")
    else:
        yield path, tree


def train_diff(torch, a, b, start=None):
    """Largest per-leaf normwise difference of two trees of tensors (dicts,
    NamedTuples), relative to ``start``'s distance from ``b`` (the size of
    an update) when given, else to ``b``'s norm."""
    worst = 0.0
    lb = dict(tree_items(b))
    ls = dict(tree_items(start)) if start is not None else None
    for key, x in tree_items(a):
        y = lb[key].detach().double().cpu()
        x = x.detach().double().cpu()
        ref = (y - ls[key].detach().double().cpu()) if ls is not None else y
        worst = max(worst, float((x - y).norm()
                                 / max(float(ref.norm()), 1e-30)))
    return worst


def train_split(torch, a, b, start, apart_by):
    """(fraction of coordinates more than ``apart_by`` apart, the largest
    per-leaf normwise difference over the other coordinates relative to
    that leaf's update from ``start``) of two trees of one structure."""
    lb, ls = dict(tree_items(b)), dict(tree_items(start))
    apart, total, worst = 0, 0, 0.0
    for key, x in tree_items(a):
        x = x.detach().double().cpu()
        y = lb[key].detach().double().cpu()
        upd = y - ls[key].detach().double().cpu()
        far = (x - y).abs() > apart_by
        apart += int(far.sum())
        total += x.numel()
        near = ~far
        worst = max(worst, float((x - y)[near].norm()
                                 / max(float(upd[near].norm()), 1e-30)))
    return apart / max(total, 1), worst


def max_abs_diff(torch, a, b) -> float:
    """Largest elementwise difference over two trees of one structure."""
    lb = dict(tree_items(b))
    return max(float((x.double() - lb[k].double()).abs().max())
               if x.numel() else 0.0 for k, x in tree_items(a))


def tree_equal(torch, a, b) -> bool:
    lb, la = dict(tree_items(b)), dict(tree_items(a))
    return la.keys() == lb.keys() and all(
        x.dtype == lb[k].dtype and torch.equal(x, lb[k].to(x.device))
        for k, x in la.items())


def tree_copy(tree, device):
    """A copy on ``device`` of a tree of tensors (dicts, NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_copy(v, device) for v in tree))
    return tree.to(device, copy=True)


def reduced_step_check(torch, gate, red, label, cgen, seed, dev, tcfg,
                       ocfg_r, patches: int = 0, grad_gate=GATE_STATS,
                       flips_gate=GATE_TRAIN_FLIPS, frames: int = 0):
    """One synchronous train step of the reduced config ``red`` (float32)
    on the card and on the port's CPU path from one state (drawn on the
    CPU from ``cgen`` seeded with ``seed``) and one batch (SyntheticLM at
    TRAIN_REDUCED_SEQ, global batch 4, with ``patches`` random patch
    embeddings and ``frames`` random frame embeddings, drawn from
    ``cgen``): nll (and aux) within GATE_TRAIN_LOSS, gradients within
    ``grad_gate`` (per leaf, normwise), AdamW from the same state and the
    CPU's gradients within GATE_TRAIN_ADAM, and after the step at most
    ``flips_gate`` of the parameters more than lr * TRAIN_APART apart,
    the others within GATE_TRAIN_STEP of the update."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as TS

    cpu = torch.device("cpu")
    cgen.manual_seed(seed)
    on_cpu = TS.init_state(red, cgen, cpu)
    on_card = tree_copy(on_cpu, dev)
    start = tree_copy(on_cpu.params, cpu)
    data = DataConfig(vocab_size=red.vocab_size, seq_len=TRAIN_REDUCED_SEQ,
                      global_batch=4)
    b_cpu = SyntheticLM(data, cpu).batch(0)
    if patches:
        b_cpu["patch_embeds"] = torch.randn(
            (4, patches, red.d_model), generator=cgen)
    if frames:
        b_cpu["enc_frames"] = torch.randn(
            (4, frames, red.d_model), generator=cgen)
    b_card = tree_copy(b_cpu, dev)
    g_cpu, m_cpu = TS.grads_of(red, tcfg, on_cpu.params, b_cpu)
    g_card, m_card = TS.grads_of(red, tcfg, on_card.params, b_card)
    keys = ("nll", "aux") if red.n_experts else ("nll",)
    e_loss = max(abs(float(m_card[k]) - float(m_cpu[k]))
                 / abs(float(m_cpu[k])) for k in keys)
    e_grad = train_diff(torch, g_card, g_cpu)
    signs = sum(int(((a.cpu() * b) < 0).sum()) for a, b in
                zip(tree_leaves(g_card), tree_leaves(g_cpu)))
    # AdamW from the same state and the CPU's gradients, card against CPU
    same_cpu, same_card = tree_copy(on_cpu, cpu), tree_copy(on_cpu, dev)
    adamw.update(ocfg_r, g_cpu, same_cpu.opt, same_cpu.params)
    adamw.update(ocfg_r, tree_copy(g_cpu, dev), same_card.opt,
                 same_card.params)
    e_adam = train_diff(torch, same_card, same_cpu)
    step_r = TS.make_train_step(red, ocfg_r, tcfg)
    step_r(on_cpu, b_cpu)
    step_r(on_card, b_card)
    apart_by = ocfg_r.lr * TRAIN_APART
    apart, e_step = train_split(torch, on_card.params, on_cpu.params, start,
                                apart_by)
    gate(e_loss <= GATE_TRAIN_LOSS and e_grad <= grad_gate
         and e_adam <= GATE_TRAIN_ADAM and apart <= flips_gate
         and e_step <= GATE_TRAIN_STEP,
         f"{label}, card against CPU: {' and '.join(keys)} rel "
         f"{e_loss:.2e}, gradients {e_grad:.2e} (largest per leaf, "
         f"normwise; {signs} coordinates of opposite sign); AdamW from the "
         f"same gradients rel {e_adam:.2e}; after the step {apart:.2e} of "
         f"the parameters more than {apart_by:.0e} apart, the others within "
         f"{e_step:.2e} of the update")


def phase15(torch, np, smi, gate, launches, plain_cuda_calls, dev, timer,
            bf16_flops, bw):
    """Training on the card: the swa autograd Function against plain
    autograd (bitwise gradients at the training shape, bf16 causal and
    windowed, and float32), the synchronous trainer on Llama-3.2-3B at
    full width and depth (TRAIN_SYNC: step wall, tokens/s, peak memory,
    swa launches per step, a profiled step's share in the backward
    recompute), the pod-consensus trainer at full width, depth cut to
    TRAIN_CONSENSUS's layers, for every scheme (theta_bar finite after
    every round, one-step pods equal to theta_bar bitwise, ADMM duals
    non-zero and pods apart, nll falling), the reduced config (float32)
    on the card against the port's CPU path (one sync step and one round
    of each scheme; GATE_TRAIN_LOSS, GATE_STATS on gradients,
    GATE_TRAIN_FLIPS and GATE_TRAIN_STEP on a step's or round's
    parameters against the size of its update, GATE_TRAIN_ADAM on AdamW
    from the same gradients), and a resumed consensus run (save after round 1,
    restore bitwise, round 2) against the uninterrupted run, within the
    spread of two uninterrupted runs."""
    import dataclasses

    import torch.nn.functional as Fn

    import repro_torch.configs as TC
    from repro_torch import checkpoint as CK
    from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                           pod_sharded_batches)
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.kernels.swa import ops as sops
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import consensus as CT
    from repro_torch.train import step as TS

    t_phase = time.perf_counter()
    print(f"phase 15: training ({smi})", flush=True)

    # ---- the autograd Function against plain autograd -------------------
    b, s_len, h, kh, d = TRAIN_SWA
    gen = torch.Generator(device=dev)
    gen.manual_seed(20120615)
    recompute_ms = None
    for dtype, shape, window in (
            (torch.bfloat16, TRAIN_SWA, 0),
            (torch.bfloat16, TRAIN_SWA, TRAIN_WINDOW),
            (torch.float32, TRAIN_SWA_F32, 0)):
        b_, s_, h_, kh_, d_ = shape
        q, k, v = (torch.randn((b_, s_, n, d_), generator=gen, device=dev)
                   .to(dtype).requires_grad_(True) for n in (h_, kh_, kh_))
        g = torch.randn((b_, s_, h_, d_), generator=gen, device=dev).to(dtype)
        n0 = smod.swa_attention.launches
        out = sops.swa_op(q, k, v, window=window)
        got = torch.autograd.grad(out, (q, k, v), g)
        fwd_launches = smod.swa_attention.launches - n0
        want = torch.autograd.grad(
            smod.swa_attention_ref(q, k, v, window=window), (q, k, v), g)
        with torch.no_grad():
            ref32 = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                           window=window)
        torch.cuda.synchronize()
        same = all(torch.equal(a, w) for a, w in zip(got, want))
        name = str(dtype).split(".")[-1]
        e = rel_err(out.detach(), ref32)
        tag = (f"b={b_} s={s_} h/kh={h_}/{kh_} d={d_} {name} "
               f"window={window}")
        gate(same and e <= GATE_SWA[name] and fwd_launches == 1,
             f"swa Function {tag}: dq, dk, dv bitwise equal to plain "
             f"autograd {same}; forward rel {e:.2e} against the plain "
             f"version in float32; kernel launches {fwd_launches}")
        if dtype == torch.bfloat16 and window == 0:
            # the backward's cost: the plain forward and its autograd
            def recompute():
                torch.autograd.grad(smod.swa_attention_ref(
                    q, k, v, window=window), (q, k, v), g)

            def kernel_fwd():
                with torch.no_grad():
                    smod.swa_attention(q, k, v, window=window)
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            gt = g.transpose(1, 2)

            def library():      # SDPA forward and backward: a yardstick
                torch.autograd.grad(Fn.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                    (qt, kt, vt), gt)
            recompute_ms = timer(recompute, 5)
            fwd_ms = timer(kernel_fwd, 10)
            lib_ms = timer(library, 10)
            pairs = s_len * (s_len + 1) // 2
            # a flash backward: 5 products of the band (dS, dP, dV, dQ, dK)
            bound = 10 * d * pairs * b * h / bf16_flops * 1e3
            print(f"  swa at the training shape {tag}: kernel forward "
                  f"{fwd_ms:.4f} ms, backward by plain recompute "
                  f"{recompute_ms:.4f} ms a layer, a flash backward's bound "
                  f"{bound:.4f} ms (operations); sdpa forward and backward "
                  f"{lib_ms:.4f} ms", flush=True)
            del qt, kt, vt, gt
        del q, k, v, g, out, got, want, ref32
    torch.cuda.empty_cache()

    # ---- synchronous trainer, full width and depth ----------------------
    llama = TC.get("llama3.2-3b")
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                             total_steps=TRAIN_SYNC["steps"])
    tcfg = TS.TrainConfig()
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(15)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TS.init_state(llama, mgen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    print(f"  sync trainer: {llama.arch_id}, {llama.n_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters ({llama.dtype}), state drawn "
          f"in {time.perf_counter() - t0:.2f} s; b={TRAIN_SYNC['batch']} "
          f"s={TRAIN_SYNC['seq']}, remat on, lr {TRAIN_LR}", flush=True)
    ds = SyntheticLM(DataConfig(vocab_size=llama.vocab_size,
                                seq_len=TRAIN_SYNC["seq"],
                                global_batch=TRAIN_SYNC["batch"]), dev)
    step = TS.make_train_step(llama, ocfg, tcfg)
    torch.cuda.reset_peak_memory_stats()
    nll, walls, per_step, plain_per_step = [], [], [], []
    train_launches = 0
    for i in range(TRAIN_SYNC["steps"]):
        batch = ds.batch(i)
        smod.swa_attention.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        per_step.append(smod.swa_attention.launches)
        plain_per_step.append(plain_cuda_calls["n"])
        nll.append(float(metrics["nll"]))
    train_launches += sum(per_step)
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_SYNC["batch"] * TRAIN_SYNC["seq"]
    steady = statistics.median(walls[1:])
    print(f"  sync steps: nll " + ", ".join(f"{x:.4f}" for x in nll))
    print(f"  sync step wall {', '.join(f'{w:.4f}' for w in walls)} s "
          f"(median after the first {steady:.4f} s, "
          f"{tokens / steady:.1f} tokens/s); peak device memory "
          f"{peak / 2**30:.2f} GiB ({smi})", flush=True)
    gate(all(np.isfinite(nll)) and nll[-1] < nll[0]
         and all(n == 2 * llama.n_layers for n in per_step)
         and all(n == llama.n_layers for n in plain_per_step),
         f"sync trainer: losses finite, last nll {nll[-1]:.4f} below the "
         f"first {nll[0]:.4f}; swa launches per step {per_step} (forward "
         f"and remat recompute, {2 * llama.n_layers} expected); plain swa "
         f"calls per step {plain_per_step} (the backward's recompute, one "
         f"a layer)")

    # one more step under the profiler: the backward recompute's share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    backward = sops.SwaFunction.backward

    def traced(ctx, g):
        with record_function("swa_backward_recompute"):
            return backward(ctx, g)
    sops.SwaFunction.backward = staticmethod(traced)
    try:
        batch = ds.batch(TRAIN_SYNC["steps"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        sops.SwaFunction.backward = backward
    events = prof.events()
    # the range's own device-side mirror is not a kernel: leave it out
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name != "swa_backward_recompute"]
    kernel_us = sum(e.time_range.elapsed_us() for e in device)
    marked = [e for e in events if e.name == "swa_backward_recompute"
              and e.device_type == DeviceType.CPU]
    rec_us = sum(e.device_time_total for e in marked)
    print(f"  profiled sync step: wall {wall:.3f} s, device time "
          f"{kernel_us / 1e6:.3f} s; backward recompute {rec_us / 1e3:.1f} "
          f"ms over {len(marked)} ranges = "
          f"{100 * rec_us / max(kernel_us, 1e-9):.1f}% of device time "
          f"(under the profiler); by CUDA events {llama.n_layers} x "
          f"{recompute_ms:.4f} ms = "
          f"{100 * llama.n_layers * recompute_ms / 1e3 / steady:.1f}% of "
          f"the median step wall", flush=True)
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"    device {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    del state, metrics, prof, events, device
    torch.cuda.empty_cache()

    # ---- consensus trainer, full width, depth cut -----------------------
    cc = TRAIN_CONSENSUS
    cfg_c = dataclasses.replace(llama, n_layers=cc["layers"])
    ocfg_c = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                               total_steps=cc["h_steps"] * cc["rounds"])
    ds_c = SyntheticLM(DataConfig(vocab_size=llama.vocab_size,
                                  seq_len=cc["seq"],
                                  global_batch=cc["batch"]), dev)
    print(f"  consensus trainer: {cfg_c.n_layers} of {llama.n_layers} "
          f"layers (cut: two pods' stacked state is about 30 bytes a "
          f"parameter), full width, {cc['pods']} pods, h_steps "
          f"{cc['h_steps']}, {cc['rounds']} rounds, global batch "
          f"{cc['batch']} at s={cc['seq']}", flush=True)
    for scheme in CT.SCHEMES:
        ccfg = CT.ConsensusConfig(n_pods=cc["pods"], scheme=scheme,
                                  h_steps=cc["h_steps"])
        mgen.manual_seed(16)
        cstate = CT.init_state(cfg_c, mgen, ccfg, dev)
        round_fn = CT.make_round_step(cfg_c, ocfg_c, tcfg, ccfg)
        batches = pod_sharded_batches(ds_c, cc["pods"], cc["h_steps"])
        torch.cuda.reset_peak_memory_stats()
        nlls, walls, ok_rounds = [], [], True
        smod.swa_attention.launches = 0
        for r in range(cc["rounds"]):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cstate, metrics = round_fn(cstate, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            nlls.append(float(metrics["nll"]))
            finite = all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(cstate.theta_bar))
            pods = list(tree_leaves(cstate.params))
            bars = list(tree_leaves(cstate.theta_bar))
            if scheme == "admm":
                shape_ok = any(bool(lam.any()) for lam in
                               tree_leaves(cstate.lam)) and any(
                    not torch.equal(p[0], p[1]) for p in pods)
            else:
                shape_ok = all(torch.equal(p[i], tb) for p, tb in
                               zip(pods, bars) for i in range(cc["pods"]))
            ok_rounds &= finite and shape_ok
        n_launch = smod.swa_attention.launches
        train_launches += n_launch
        want = 2 * cfg_c.n_layers * cc["pods"] * cc["h_steps"] * cc["rounds"]
        gate(ok_rounds and nlls[-1] < nlls[0] and n_launch == want,
             f"consensus {scheme}: theta_bar finite after every round and "
             + ("duals non-zero, pods apart" if scheme == "admm" else
                "every pod equal to theta_bar bitwise")
             + f" {ok_rounds}; nll {', '.join(f'{x:.4f}' for x in nlls)}; "
             f"round walls {', '.join(f'{w:.3f}' for w in walls)} s; peak "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; swa "
             f"launches {n_launch} ({want} expected)")
        del cstate, metrics, batch, pods, bars
        torch.cuda.empty_cache()
    launches["swa"] += train_launches
    print(f"  swa launches on the training path {train_launches}",
          flush=True)

    # ---- the card against the CPU (reduced config, float32) -------------
    red = TC.reduced(llama)
    ocfg_r = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = torch.device("cpu")

    cgen = torch.Generator()
    data = DataConfig(vocab_size=red.vocab_size, seq_len=TRAIN_REDUCED_SEQ,
                      global_batch=4)
    reduced_step_check(torch, gate, red, "reduced sync step", cgen, 17, dev,
                       tcfg, ocfg_r)
    apart_by = ocfg_r.lr * TRAIN_APART
    for scheme in CT.SCHEMES:
        ccfg = CT.ConsensusConfig(n_pods=2, scheme=scheme, h_steps=2)
        cgen.manual_seed(18)
        c_cpu = CT.init_state(red, cgen, ccfg, cpu)
        c_card = tree_copy(c_cpu, dev)
        c_start = tree_copy(c_cpu, cpu)
        round_fn = CT.make_round_step(red, ocfg_r, tcfg, ccfg)
        bcpu = next(pod_sharded_batches(SyntheticLM(data, cpu), 2, 2))
        bdev = next(pod_sharded_batches(SyntheticLM(data, dev), 2, 2))
        c_cpu, m_cpu = round_fn(c_cpu, bcpu)
        c_card, m_card = round_fn(c_card, bdev)
        e_loss = abs(float(m_card["nll"]) - float(m_cpu["nll"])) \
            / abs(float(m_cpu["nll"]))
        a_bar, e_bar = train_split(torch, c_card.theta_bar,
                                   c_cpu.theta_bar, c_start.theta_bar,
                                   apart_by)
        a_pods, e_pods = train_split(torch, c_card.params, c_cpu.params,
                                     c_start.params, apart_by)
        gate(e_loss <= GATE_TRAIN_LOSS and max(a_bar, a_pods)
             <= GATE_TRAIN_FLIPS and max(e_bar, e_pods) <= GATE_TRAIN_STEP,
             f"reduced {scheme} round, card against CPU: nll rel "
             f"{e_loss:.2e}; more than {apart_by:.0e} apart: theta_bar "
             f"{a_bar:.2e},"
             f" pods {a_pods:.2e} of the coordinates; the others within "
             f"{e_bar:.2e} / {e_pods:.2e} of the round's update")

    # ---- resume: save after round 1, restore, round 2 -------------------
    import tempfile
    ccfg = CT.ConsensusConfig(n_pods=2, scheme="admm", h_steps=2)
    round_fn = CT.make_round_step(red, ocfg_r, tcfg, ccfg)

    def fresh():
        cgen.manual_seed(19)
        return tree_copy(CT.init_state(red, cgen, ccfg, cpu), dev)

    def rounds(state, start_round, n):
        batches = pod_sharded_batches(SyntheticLM(data, dev), 2, 2,
                                      start_round=start_round)
        for _ in range(n):
            state, _ = round_fn(state, next(batches))
        return state

    run_a = rounds(fresh(), 0, 2)
    run_b = rounds(fresh(), 0, 2)
    spread = max_abs_diff(torch, run_a, run_b)
    part = rounds(fresh(), 0, 1)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        CK.save(tmp, 1, part, extra={"scheme": "admm"})
        restored = CK.restore(tmp, CK.latest_step(tmp), fresh())
    exact = tree_equal(torch, restored, part)
    resumed = rounds(restored, 1, 1)
    d_resume = max_abs_diff(torch, resumed, run_a)
    gate(exact and d_resume <= 2 * spread,
         f"resume (reduced admm, saved after round 1): restore bitwise "
         f"{exact}; resumed against uninterrupted, largest difference "
         f"{d_resume:.3e}, two uninterrupted runs {spread:.3e} (within "
         f"twice the spread; 0 means bitwise)")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)


def rel32(a, c):
    """Normwise relative difference in float32, a batch row at a time (a
    float32 copy of a 200k-word vocabulary's logits is 6.6 GB)."""
    num = den = 0.0
    for x, y in zip(a, c):
        x, y = x.float(), y.float()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return (num / den) ** 0.5


@contextlib.contextmanager
def recording(TM):
    """``TM.route`` (``repro_torch.models.moe``) with each call's (tokens,
    Routing) noted in the list yielded (the tensors stay on the card until
    read)."""
    plain, routes = TM.route, []

    def noting(cfg, router, xt, n_groups=16):
        r = plain(cfg, router, xt, n_groups)
        routes.append((xt.shape[0], r))
        return r
    TM.route = noting
    try:
        yield routes
    finally:
        TM.route = plain


@contextlib.contextmanager
def counting_calls(mod, attr: str):
    """``mod.attr`` counting its calls on CUDA tensors in the dict yielded
    (key ``"n"``); restored after."""
    plain, calls = getattr(mod, attr), {"n": 0}

    def counted(*args, **kwargs):
        if any(getattr(a, "is_cuda", False) for a in args):
            calls["n"] += 1
        return plain(*args, **kwargs)
    setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        setattr(mod, attr, plain)


def teacher_forced(torch, cfg, params, prompt, cont, pad=0,
                   enc_frames=None):
    """Prefill of ``prompt`` and decode of ``cont`` (teacher-forced)
    against one forward over both: (rel prefill, [rel decode a step],
    finite, (top-k choices that differ, choices)). Decode routes dropless
    (b tokens a step), so the expert models run dropless here (a capacity
    of at least Tg slots an expert). ``pad`` zero tokens are appended to
    the forward alone (not for the expert models): an xLSTM forward takes
    only lengths its chunk divides, and the causal forward's logits at the
    compared positions do not depend on later tokens. An encoder-decoder
    takes ``enc_frames``: the forward and the prefill encode them, and the
    decode steps attend to one more encoding of them."""
    import dataclasses

    from repro_torch.models import decoding as TD
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    tf = cfg if not cfg.n_experts else dataclasses.replace(
        cfg, capacity_factor=(cfg.n_experts + 0.5) / cfg.experts_per_tok)
    b, s = prompt.shape
    n = cont.shape[1]
    torch.cuda.empty_cache()
    with recording(TM) as routes, torch.no_grad():
        tok = torch.cat([prompt, cont], 1)
        ref, _ = TT.forward(tf, params, torch.cat(
            [tok, tok.new_zeros((b, pad))], 1), enc_frames=enc_frames)
        logits, cache = TD.prefill(tf, params, prompt, s + n,
                                   enc_frames=enc_frames)
        enc_out = (TT.encode(tf, params, enc_frames)
                   if enc_frames is not None else None)
        e_pre = rel32(logits, ref[:, :s])
        finite = bool(torch.isfinite(ref).all())
        del logits
        e_dec = []
        for t in range(n):
            lg, cache = TT.decode_step(tf, params, cache,
                                       tok[:, s + t:s + t + 1], s + t,
                                       enc_out=enc_out)
            e_dec.append(rel32(lg[:, 0], ref[:, s + t]))
        del ref, cache, enc_out

    def choices(t):
        """Each layer's sorted top-k experts of the calls of t tokens."""
        return torch.stack([r.gate_idx.reshape(t, -1).sort(-1).values
                            for tt, r in routes if tt == t])

    flips = (0, 0)
    if cfg.n_experts:
        dec = choices(b)                                # (n L, b, k)
        layers = dec.shape[0] // n
        fwd = choices(b * (s + n))                      # (L, b(s+n), k)
        fwd = fwd.reshape(layers, b, s + n, -1)[:, :, s:]
        dec = dec.reshape(n, layers, b, -1)
        differ = (dec.permute(1, 2, 0, 3) != fwd).any(-1)
        flips = (int(differ.sum()), differ.numel())
    return e_pre, e_dec, finite, flips


def phase16(torch, smi, gate, plain_cuda_calls, dev, prefill_shape,
            check_swa, time_swa) -> int:
    """The attention families at full width (ZOO), one model at a time,
    with weights drawn on the card from a seeded generator and freed
    before the next: the swa kernel against its plain version at the
    model's prefill shape (timed beside the plain version and SDPA);
    generate at phase 8's shape
    twice through the kernel path (one launch a layer, no plain attention
    on a CUDA tensor, bitwise equal tokens); prefill seconds, decode ms
    per step and peak memory; prefill and teacher-forced decode against
    one full forward (GATE_SERVE; dropless for the expert models, since
    decode routes dropless; their bf16 decode gated where every top-k
    choice agrees with the forward's, and held within GATE_TF32 in
    float32 at ZOO_F32_LAYERS); the routing of one prefill (the capacity
    path, its dropped share) and one decode step (dropless) of each
    expert model; llama4-scout's prefill with random patch embeddings and
    decode steps after it; each model's profiled prefill (the device's
    busy share, the swa kernel's device time a launch). Then the six
    reduced configs (float32) on the card against the CPU. Returns the
    swa launches of the main-path runs."""
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import decoding as TD
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    t_phase = time.perf_counter()
    print(f"phase 16: the attention families at full width ({smi})",
          flush=True)
    b, s_len, n_new = prefill_shape
    total = 0

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    for i, (arch, depth) in enumerate(ZOO):
        full = TC.get(arch)
        cfg = full if depth is None else dataclasses.replace(full,
                                                             n_layers=depth)
        mla = cfg.attn_kind == "mla"
        h = cfg.n_heads
        kh = h if mla else cfg.n_kv_heads
        d = cfg.qk_nope_dim + cfg.qk_rope_dim if mla else cfg.hd
        what = (f"{cfg.n_experts} experts top-{cfg.experts_per_tok}"
                if cfg.n_experts else "dense") + (", MLA" if mla else "") \
            + (", qk-norm" if cfg.qk_norm else "") \
            + (f", {cfg.n_patches} patches" if cfg.n_patches else "")
        print(f"  {arch}: {cfg.n_layers} of {full.n_layers} layers, "
              f"d={cfg.d_model}, {h}/{kh} attention heads at width {d}, "
              f"{what}, {cfg.dtype}", flush=True)

        # the kernel at this model's prefill shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(1600 + i)
        q = torch.randn((b, s_len, h, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k, v = (torch.randn((b, s_len, kh, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        if mla:    # V zero-padded from v_head_dim to the q k width
            v = torch.nn.functional.pad(v[..., :cfg.v_head_dim],
                                        (0, d - cfg.v_head_dim))
        tag = f"{arch} prefill b={b} s={s_len} h/kh={h}/{kh} d={d}"
        check_swa(tag, q, k, v, 0)
        time_swa(tag, q, k, v, 0, 10)
        del q, k, v
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = TT.model_init(cfg, gen, device=dev)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
        n_params = sum(t.numel() for t in leaves(params))
        print(f"    weights: {n_params / 1e9:.3f} B parameters, "
              f"{nbytes / 1e9:.3f} GB, drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s (peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)",
              flush=True)
        prompt = torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                               device=dev)
        TD.generate(cfg, params, prompt[:1, :64], 2)    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def serve(label):
            nonlocal total
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = TD.generate(cfg, params, prompt, n_new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            nl, pc = smod.swa_attention.launches, plain_cuda_calls["n"]
            total += nl
            gate(nl == cfg.n_layers and pc == 0 and out.shape == (b, n_new),
                 f"{arch} {label}: generate {tuple(out.shape)} in "
                 f"{wall:.3f} s ({out.numel() / wall:.1f} tokens/s end to "
                 f"end); flash-attention launches {nl} (one prefill of "
                 f"{cfg.n_layers} layers), plain calls on CUDA tensors {pc}")
            return out

        out1 = serve(f"b={b} prompt={s_len}")
        out2 = serve(f"b={b} prompt={s_len}, again")
        gate(torch.equal(out1, out2), f"{arch}: greedy decoding gives "
             f"identical tokens on a second run")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TD.prefill(cfg, params, prompt, s_len + n_new)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        last = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        del logits
        step = TD.make_serve_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_new - 1):
            last, _, cache = step(params, cache, last, s_len + t)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / (n_new - 1)
        del cache
        print(f"    prefill {t_pre:.4f} s ({b * s_len / t_pre:.0f} prompt "
              f"tokens/s), decode {1e3 * t_dec:.3f} ms per step "
              f"({b / t_dec:.1f} tokens/s at batch {b}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"({smi})", flush=True)
        gate(finite, f"{arch}: prefill logits finite")

        e_pre, e_dec, finite, flips = teacher_forced(torch, cfg, params,
                                                     prompt,
                                                     out1[:, :ZOO_EXTRA])
        # a top-k choice that differs (bf16 rounding between the decode and
        # the forward paths, among near-uniform random router
        # probabilities) makes a different function: the bf16 decode is
        # gated only where every choice agreed, and the expert models'
        # decode continuation is held in float32 below
        gate(finite and e_pre <= GATE_SERVE
             and (max(e_dec) <= GATE_SERVE or flips[0] > 0),
             f"{arch}: prefill + teacher-forced decode against one forward "
             f"over {s_len + ZOO_EXTRA} tokens"
             + (" (both dropless)" if cfg.n_experts else "")
             + f": rel prefill {e_pre:.2e}, decode "
             + ", ".join(f"{e:.2e}" for e in e_dec)
             + (f"; {flips[0]} of {flips[1]} (token, layer) top-"
                f"{cfg.experts_per_tok} choices differ between decode and "
                f"the forward" if cfg.n_experts else ""))
        torch.cuda.empty_cache()

        if cfg.n_experts:
            with recording(TM) as routes:
                logits, cache = TD.prefill(cfg, params, prompt, s_len + 1)
                TT.decode_step(cfg, params, cache,
                               torch.argmax(logits[:, -1:, :cfg.vocab_size],
                                            -1), s_len)
            del logits, cache
            # (tokens, capacity, tokens a group, pairs, dropped pairs)
            routed = [(t, r.cap, t // r.keep.shape[0], r.keep.numel(),
                       int((~r.keep).sum())) for t, r in routes]
            pre, dec = routed[:cfg.n_layers], routed[cfg.n_layers:]
            pairs = sum(r[3] for r in pre)
            dropped = sum(r[4] for r in pre)
            gate(len(dec) == cfg.n_layers
                 and all(r[0] > TM.DROPLESS_TOKENS and r[1] < r[2]
                         for r in pre)
                 and all(r[0] <= TM.DROPLESS_TOKENS and r[1] == r[2]
                         and r[4] == 0 for r in dec),
                 f"{arch}: prefill routes {pre[0][0]} tokens on the capacity "
                 f"path ({pre[0][1]} slots an expert for {pre[0][2]} tokens "
                 f"a group), {dropped} of {pairs} (token, slot) pairs "
                 f"dropped ({100 * dropped / pairs:.2f}%, all layers); "
                 f"decode routes {dec[0][0]} tokens dropless")

        if cfg.n_patches:
            patches = torch.randn((b, cfg.n_patches, cfg.d_model),
                                  generator=gen, device=dev) \
                .to(cfg.torch_dtype)
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = TD.prefill(cfg, params, prompt, s_len + n_new,
                                       patch_embeds=patches)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            nl, pc = smod.swa_attention.launches, plain_cuda_calls["n"]
            total += nl
            finite = bool(torch.isfinite(logits).all())
            last = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            del logits
            outs = []
            for t in range(n_new - 1):
                last, lg, cache = step(params, cache, last, s_len + t)
                outs.append(last)
                finite = finite and bool(torch.isfinite(lg).all())
            del cache
            same = torch.equal(torch.cat(outs, 1), out1[:, 1:])
            gate(nl == cfg.n_layers and pc == 0 and finite,
                 f"{arch}: prefill with {cfg.n_patches} random patch "
                 f"embeddings in {t_pre:.4f} s, then {n_new - 1} decode "
                 f"steps: logits finite, flash-attention launches {nl}, "
                 f"plain calls on CUDA tensors {pc}; tokens equal to the "
                 f"text-only run's {same}")

        # the busy share of a prefill, and the swa kernel's device time at
        # this model's shape from the same trace
        torch.cuda.empty_cache()
        by_name = device_profile(
            torch, f"{arch} prefill b={b} prompt={s_len}",
            lambda: TD.prefill(cfg, params, prompt, s_len + n_new))
        us, n = map(sum, zip(*[v for name, v in by_name.items()
                               if "swa_" in name] or [(0.0, 0)]))
        print(f"    swa device time {us / 1e3 / max(n, 1):.4f} ms a launch "
              f"({n} launches in the profiled prefill)", flush=True)
        cont = out1[:, :ZOO_EXTRA]
        del params, out1, out2
        torch.cuda.empty_cache()

        if cfg.n_experts:
            # float32 at full width, depth cut to fit float32 weights
            cfg32 = dataclasses.replace(
                cfg, n_layers=ZOO_F32_LAYERS[arch], dtype="float32")
            params = TT.model_init(cfg32, gen, device=dev)
            e_pre, e_dec, finite, flips = teacher_forced(torch, cfg32,
                                                         params, prompt,
                                                         cont)
            gate(finite and max([e_pre] + e_dec) <= GATE_TF32,
                 f"{arch} float32, {cfg32.n_layers} layers: prefill + "
                 f"teacher-forced decode against one forward (both "
                 f"dropless): rel prefill {e_pre:.2e}, decode "
                 + ", ".join(f"{e:.2e}" for e in e_dec)
                 + f"; {flips[0]} of {flips[1]} top-"
                 f"{cfg.experts_per_tok} choices differ")
            del params
            torch.cuda.empty_cache()
        del prompt, cont

    # ---- the reduced configs on the card against the CPU (float32) ------
    for arch, _ in ZOO:
        red = TC.reduced(TC.get(arch))
        cgen = torch.Generator()
        cgen.manual_seed(16)
        on_cpu = TT.model_init(red, cgen, "cpu")
        on_card = _tree_to(on_cpu, dev)
        tok = torch.randint(0, red.vocab_size, (2, 64), generator=cgen)
        pe = (torch.randn((2, red.n_patches, red.d_model), generator=cgen)
              if red.n_patches else None)
        smod.swa_attention.launches = 0
        want, want_aux = TT.forward(red, on_cpu, tok, patch_embeds=pe)
        got, aux = TT.forward(red, on_card, tok.to(dev),
                              patch_embeds=None if pe is None else pe.to(dev))
        nl = smod.swa_attention.launches
        e = rel_err(got.cpu(), want)
        e_aux = abs(float(aux) - float(want_aux)) / max(abs(float(want_aux)),
                                                        1e-30)
        gate(e <= GATE_STATS and (not red.n_experts or e_aux <= GATE_STATS)
             and nl == red.n_layers,
             f"reduced {arch} (float32) on the card against the CPU: logits "
             f"rel {e:.2e}, aux {float(aux):.6f} against "
             f"{float(want_aux):.6f}; flash-attention launches {nl}")
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase17(torch, np, A, smi, gate, plain_cuda_calls, dev, timer, rates,
            paper_potts, g_field, th_field, X_field):
    """bfloat16 operands of the score, cl_logits and gram kernels (see the
    module docstring, item 17). Returns (launches, rows, errs) of the
    kernels line's bfloat16 rows: the launches of the entry-point drive,
    the timed rows and the largest absolute errors against the plain
    versions on the float32 upcasts."""
    import repro_torch.kernels.cl as TK
    from repro_torch.kernels.cl import kernel as kmod
    from repro_torch.kernels.cl.family import (family_kernel_inputs,
                                               family_score_stats)
    from repro_torch.kernels.cl.ops import (conditional_logits_op,
                                            score_stats_op)
    from repro_torch.kernels.gram import kernel as gmod
    from repro_torch.kernels.gram.ops import gram_op

    t_phase = time.perf_counter()
    print(f"phase 17: bfloat16 operands of the score, cl_logits and gram "
          f"kernels ({smi})", flush=True)
    bw, flops, bf16_flops = rates
    bf16 = torch.bfloat16
    tol16 = TK.precision_tolerance("bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20260226)
    errs = {"score_c1": 0.0, "score_cn": 0.0, "cl_logits": 0.0, "gram": 0.0}

    def ulps(got, want32):
        """Largest |got - want32 rounded once| past 1e-6, in bfloat16 ulps
        of the rounded value (8 significant bits)."""
        want = want32.to(bf16).float()
        _, e = torch.frexp(want.abs())
        ulp = torch.ldexp(torch.ones_like(want), e - 8)
        d = ((got.float() - want).abs() - 1e-6).clamp_min(0) / ulp
        return float(d.max()) if d.numel() else 0.0

    def same_or_nan(a, b):
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])

    def grid_mask(side):
        p = side * side
        m = torch.zeros((p, p), device=dev)
        idx = torch.arange(p, device=dev)
        right, down = idx[idx % side < side - 1], idx[idx // side < side - 1]
        m[right, right + 1] = m[right + 1, right] = 1.0
        m[down, down + side] = m[down + side, down] = 1.0
        return m

    def case(kind, C, n, p, mask="density .1"):
        """bfloat16 (F, Theta, A, b) of a kind; Theta scaled by the mean
        degree so that eta is O(1)."""
        x = torch.randint(0, C + 1, (n, p), generator=gen, device=dev)
        if kind == "gaussian":
            F = torch.randn((1, n, p), generator=gen, device=dev)
        elif kind == "ising":
            F = (2.0 * (x > 0).float() - 1.0)[None]
        else:
            F = torch.stack([(x == c).float() for c in range(1, C + 1)])
        if mask == "grid 16x16":
            Am = grid_mask(16)
        elif mask == "density 1.0":
            Am = torch.ones((p, p), device=dev)
        else:
            Am = (torch.rand((p, p), generator=gen, device=dev)
                  < float(mask.split()[1])).float()
            Am = ((Am + Am.T) > 0).float()
        deg = max(1.0, float(Am.sum()) / p)
        th = torch.randn((C, p, p), generator=gen, device=dev) / deg ** 0.5
        th = (th + th.transpose(1, 2)) / 2
        bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
        return tuple(t.to(bf16).contiguous() for t in (F, th, Am, bias))

    def check_score(tag, kind, args):
        C = args[0].shape[0]
        up = tuple(t.float() for t in args)
        n0 = kmod.cl_score_channels.launches
        got = kmod.cl_score_channels(*args, kind=kind)
        one = kmod.cl_score_channels.launches == n0 + 1
        same = all(torch.equal(a, b) for a, b in
                   zip(got, kmod.cl_score_channels(*args, kind=kind)))
        f32 = kmod.cl_score_channels(*up, kind=kind)
        rounded = (torch.equal(got[0], f32[0].to(bf16))
                   and torch.equal(got[1], f32[1].to(bf16))
                   and torch.equal(got[2], f32[2]))
        del f32
        want = kmod.cl_score_channels_ref(*up, kind)
        u = max(ulps(got[0], want[0]), ulps(got[1], want[1]))
        eS = rel_err(got[2], want[2])
        key = "score_c1" if C == 1 else "score_cn"
        errs[key] = max(errs[key], *(abs_err(g, w) for g, w in
                                     zip(got, want)))
        del want
        plain = kmod.cl_score_channels_ref(*args, kind)
        e16 = max(rel_err(g, w) for g, w in zip(got, plain))
        del plain
        types = [t.dtype for t in got] == [bf16, bf16, torch.float32]
        torch.cuda.synchronize()
        gate(u <= 1 and eS <= GATE_STATS and e16 <= tol16 and rounded
             and same and one and types,
             f"score bf16 {tag}: eta, r within {u:.2f} ulp of the plain "
             f"version on the upcasts; rel S {eS:.2e}; rel to the bf16 "
             f"plain version {e16:.2e}; the float32 kernel's rounded "
             f"{rounded}; repeat bitwise {same}; one launch {one}")
        return got

    def check_logits(tag, args):
        up = tuple(t.float() for t in args)
        n0 = kmod.cl_logits.launches
        got = kmod.cl_logits(*args)
        one = kmod.cl_logits.launches == n0 + 1
        same = torch.equal(got, kmod.cl_logits(*args))
        rounded = torch.equal(got, kmod.cl_logits(*up).to(bf16))
        want = kmod.cl_logits_ref(*up)
        u = ulps(got, want)
        errs["cl_logits"] = max(errs["cl_logits"], abs_err(got, want))
        del want
        e16 = rel_err(got, kmod.cl_logits_ref(*args))
        torch.cuda.synchronize()
        gate(u <= 1 and e16 <= tol16 and rounded and same and one
             and got.dtype == bf16,
             f"cl_logits bf16 {tag}: within {u:.2f} ulp of the plain "
             f"version on the upcasts; rel to the bf16 plain version "
             f"{e16:.2e}; the float32 kernel's rounded {rounded}; repeat "
             f"bitwise {same}; one launch {one}")

    def check_gram(tag, S):
        n0 = gmod.gram.launches
        got = gmod.gram(S)
        one = gmod.gram.launches == n0 + 1
        same = torch.equal(got, gmod.gram(S))
        sym = torch.equal(got, got.T)
        rounded = torch.equal(got, gmod.gram(S.float()))
        want = gmod.gram_ref(S.float())
        e = rel_err(got, want)
        errs["gram"] = max(errs["gram"], abs_err(got, want))
        e16 = rel_err(got, gmod.gram_ref(S))
        torch.cuda.synchronize()
        gate(e <= GATE_GRAM and e16 <= tol16 and same and sym and rounded
             and one and got.dtype == torch.float32,
             f"gram bf16 {tag}: rel {e:.2e} to the plain version on the "
             f"upcasts, {e16:.2e} to the bf16 one; the float32 kernel's "
             f"{rounded}; repeat bitwise {same}; symmetric {sym}; one "
             f"launch {one}")

    for n, p in BF16_SHAPES:
        for kind, C in (("ising", 1), ("gaussian", 1), ("potts", 2),
                        ("potts", 3), ("potts", 5)):
            check_score(f"{kind} C={C} n={n} p={p}", kind,
                        case(kind, C, n, p))
        for C in range(1, 6):
            check_logits(f"C={C} n={n} p={p}",
                         case("potts" if C > 1 else "gaussian", C, n, p))
    for mask, n, p in BF16_MASKS:
        for kind, C in (("ising", 1), ("gaussian", 1), ("potts", 3)):
            check_score(f"{kind} C={C} n={n} p={p} {mask}", kind,
                        case(kind, C, n, p, mask))
        for C in (1, 3, 5):
            check_logits(f"C={C} n={n} p={p} {mask}",
                         case("potts" if C > 1 else "gaussian", C, n, p,
                              mask))
    for n, d in BF16_GRAM:
        check_gram(f"n={n} d={d}",
                   torch.randn((n, d), generator=gen, device=dev).to(bf16))
    flat = torch.randn((1001 * 128 + 2,), generator=gen,
                       device=dev).to(bf16)
    for off in (1, 2):
        check_gram(f"n=1001 d=128 view at element {off}",
                   flat[off:off + 1001 * 128].view(1001, 128))

    # the non-finite cases of tests/test_torch_cuda.py, in bfloat16
    nf_fail = []
    for p, mask_kind, poison in BF16_NONFINITE:
        for op in ("ising", "gaussian", "potts", "logits C=1", "logits C=3"):
            C = {"potts": 2, "logits C=3": 3}.get(op, 1)
            n = 333
            x = torch.randint(0, 3, (n, p), generator=gen, device=dev)
            if op == "potts":
                F = torch.stack([(x == c).float() for c in range(1, C + 1)])
            elif op == "ising":
                F = (2.0 * (x > 0).float() - 1.0)[None]
            else:
                F = torch.randn((C, n, p), generator=gen, device=dev)
            th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
            if mask_kind.startswith("grid"):
                Am = torch.zeros((p, p), device=dev)
                Am[:256, :256] = grid_mask(16)
            else:
                Am = (torch.rand((p, p), generator=gen, device=dev)
                      < .05).float()
            bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
            rng = np.random.RandomState(p)
            if poison == "a row of F":
                row = F[C - 1, rng.randint(n)]
                row[:] = float("inf")
                row[rng.randint(p)] = float("nan")
            if poison in ("F and Theta", "F only"):
                for v, j in zip((float("nan"), float("inf"), -float("inf")),
                                (rng.randint(p), rng.randint(p), p - 1)):
                    F[rng.randint(C), rng.randint(n), j] = v
            if poison in ("F and Theta", "Theta only"):
                zeros = torch.nonzero(Am == 0.0).cpu().numpy()
                for v, (j, i) in zip(
                        (float("nan"), float("inf"), -float("inf")),
                        zeros[rng.choice(len(zeros), 3, replace=False)]):
                    th[rng.randint(C), j, i] = v
            bad = tuple(t.to(bf16) for t in (F, th, Am, bias))
            up = tuple(t.float() for t in bad)
            if op.startswith("logits"):
                got, again = (kmod.cl_logits(*bad),), (kmod.cl_logits(*bad),)
                f32, want = (kmod.cl_logits(*up),), (kmod.cl_logits_ref(*up),)
            else:
                got = kmod.cl_score_channels(*bad, kind=op)
                again = kmod.cl_score_channels(*bad, kind=op)
                f32 = kmod.cl_score_channels(*up, kind=op)
                want = kmod.cl_score_channels_ref(*up, op)
            ok = bool(torch.isnan(got[0]).any())
            for g, a, f, w in zip(got, again, f32, want):
                iv = torch.int16 if g.dtype == bf16 else torch.int32
                ok = (ok and torch.equal(g.view(iv), a.view(iv))
                      and same_or_nan(g, f.to(g.dtype))
                      and torch.equal(torch.isnan(g), torch.isnan(w))
                      and torch.equal(torch.isposinf(g), torch.isposinf(w))
                      and torch.equal(torch.isneginf(g), torch.isneginf(w)))
            if not ok:
                nf_fail.append(f"{op} p={p} {mask_kind} {poison}")
    gate(not nf_fail, f"non-finite bf16 inputs ({len(BF16_NONFINITE) * 5} "
         f"cases): NaN and +-inf where the plain version on the upcasts has "
         f"them, the float32 kernel's outputs rounded, repeats bitwise; "
         f"failed {nf_fail or 'none'}")

    # the field: family_score_stats's bfloat16 kernel inputs
    fam = A.Plan(graph=g_field).family_instance
    Xb = X_field[:16384].to(bf16)
    thf = th_field.to(dev, torch.float32)
    ff = family_kernel_inputs(fam, g_field, thf, Xb)
    gate(all(t.dtype == bf16 for t in ff),
         f"family_kernel_inputs of a bf16 X: {[str(t.dtype) for t in ff]}")
    ftag = f"field_ising n={Xb.shape[0]} p={g_field.p}"
    field = check_score(ftag, "ising", ff)
    check_logits(ftag, ff)
    torch.cuda.empty_cache()

    def extra_bytes(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base
    C, n, p = ff[0].shape
    words = kmod._workspace_words(C, p)
    splits, _ = kmod.score_launch_shape(C, n, p)
    part = splits * C * C * p * p if splits > 1 else 0
    want_score = 2 * 2 * C * n * p + 4 * C * C * p * p \
        + 4 * (C * n * p + part + words)
    want_logits = 2 * C * n * p + 4 * words
    es = extra_bytes(lambda: kmod.cl_score_channels(*ff, kind="ising"))
    el = extra_bytes(lambda: kmod.cl_logits(*ff))
    mib = 2**20
    gate(es <= want_score + ALLOC_SLACK and el <= want_logits + ALLOC_SLACK,
         f"no upcast copy (torch.cuda.max_memory_allocated around the "
         f"call): the bf16 field score call allocated {es / mib:.1f} MiB "
         f"for outputs and scratch of {want_score / mib:.1f} MiB, cl_logits "
         f"{el / mib:.1f} MiB for {want_logits / mib:.1f} MiB; a float32 "
         f"copy of F would add {4 * C * n * p / mib:.1f} MiB, of Theta "
         f"{4 * C * p * p / mib:.1f} MiB")

    def bound_at(nbytes, nflop, rate):
        tb, tf = nbytes / bw * 1e3, nflop / rate * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    rows = {}

    def time_score(tag, kind, args, reps):
        F, th, mask, bias = args
        C, n, p = F.shape
        B = (th * mask[None]).contiguous()
        _, r, _ = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
        rT = r.transpose(1, 2).contiguous()

        def library():
            torch.matmul(F, B)
            torch.matmul(rT, F)
        kms, pms, lms = timer.turns(
            lambda: kmod.cl_score_channels_ref(F, th, mask, bias, kind),
            lambda: kmod.cl_score_channels(F, th, mask, bias, kind=kind),
            library, reps)
        nnz = int(mask.count_nonzero())
        # bf16 F, Theta, A, b read and eta, r written; S float32; the
        # Gram's r is float32, so FP32 operations
        bms, by = bound_at(2 * (C * n * p + C * p * p + p * p + C * p
                                + 2 * C * n * p) + 4 * C * C * p * p,
                           2 * C * n * nnz + 2 * C * C * n * p * p, flops)
        dms = device_ms(torch, lambda: kmod.cl_score_channels(
            F, th, mask, bias, kind=kind), reps)
        print(f"  time score bf16 {tag}: kernel {kms:.4f} ms (device "
              f"{dms:.4f} ms), plain {pms:.4f} ms, 2x bf16 matmul (bf16 "
              f"out) {lms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                    bound_by=by)

    rows["score_c1"] = time_score(ftag + " C=1", "ising", ff, 3)
    F, th, mask, bias = ff
    B = (th * mask[None]).contiguous()
    b3 = bias[:, None, :]
    kms, pms, lms = timer.turns(lambda: kmod.cl_logits_ref(*ff),
                                lambda: kmod.cl_logits(*ff),
                                lambda: torch.baddbmm(b3, F, B), 3)
    nnz = int(mask.count_nonzero())
    bms, by = bound_at(2 * (2 * C * n * p + p * p + C * p + C * p * p),
                       2 * C * n * nnz, bf16_flops)
    dms = device_ms(torch, lambda: kmod.cl_logits(*ff), 3)
    rows["cl_logits"] = dict(ms=kms, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by)
    print(f"  time cl_logits bf16 {ftag}: kernel "
          f"{kms:.4f} ms (device {dms:.4f} ms), plain {pms:.4f} ms, bf16 "
          f"baddbmm (bf16 out) {lms:.4f} ms, bound {bms:.4f} ms ({by})",
          flush=True)
    del B, b3, F, th, mask, bias

    g_p, fam_p, th_p, X_p = paper_potts
    pfam = A.Plan(graph=g_p, family=fam_p).family_instance
    thp = th_p.to(dev, torch.float32)
    pf = family_kernel_inputs(pfam, g_p, thp, X_p.to(bf16))
    check_score(f"euclidean_potts3 n={X_p.shape[0]} p={g_p.p} C=2", "potts",
                pf)
    rows["score_cn"] = time_score(
        f"euclidean_potts3 n={X_p.shape[0]} p={g_p.p} C=2", "potts", pf, 50)

    S16 = torch.randn((16384, 512), generator=gen, device=dev).to(bf16)
    check_gram("kernels_bench n=16384 d=512", S16)
    n, d = S16.shape
    G0 = torch.empty((d, d), dtype=bf16, device=dev)
    kms, pms, lms = timer.turns(
        lambda: gmod.gram_ref(S16), lambda: gmod.gram(S16),
        lambda: torch.addmm(G0, S16.T, S16, beta=0.0, alpha=1.0 / n), 20)
    bms, by = bound_at(2 * n * d + 4 * d * d, n * d * (d + 1), bf16_flops)
    dms = device_ms(torch, lambda: gmod.gram(S16), 20)
    rows["gram"] = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                        bound_by=by)
    print(f"  time gram bf16 kernels_bench n={n} d={d}: kernel {kms:.4f} ms "
          f"(device {dms:.4f} ms), plain {pms:.4f} ms, bf16 addmm (bf16 "
          f"out) {lms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)

    # the entries on bfloat16 tensors, every count set to 0 just before
    kmod.cl_score_channels.launches = 0
    kmod.cl_logits.launches = 0
    gmod.gram.launches = 0
    plain_cuda_calls["n"] = 0
    e1, r1, S1 = family_score_stats(fam, g_field, thf, Xb)
    c1 = kmod.cl_score_channels.launches
    e2, r2, S2 = family_score_stats(pfam, g_p, thp, X_p.to(bf16))
    cn = kmod.cl_score_channels.launches - c1
    x, th1, m1, b1 = ff[0][0], ff[1][0], ff[2], ff[3][0]
    e3, r3, S3 = score_stats_op(x, th1, m1, b1, kind="ising")
    c1 = kmod.cl_score_channels.launches - cn
    eta = conditional_logits_op(x, th1, m1, b1)
    G = gram_op(S16)
    torch.cuda.synchronize()
    launches = {"score_c1": c1, "score_cn": cn,
                "cl_logits": kmod.cl_logits.launches,
                "gram": gmod.gram.launches}
    pc = plain_cuda_calls["n"]
    equal = (torch.equal(e1, field[0]) and torch.equal(r1, field[1])
             and torch.equal(S1, field[2]) and torch.equal(e3, field[0][0])
             and torch.equal(S3, field[2][0, 0]))
    types = ([t.dtype for t in (e1, r1, S1, e2, r2, S2, eta, G)]
             == [bf16, bf16, torch.float32] * 2 + [bf16, torch.float32])
    finite = all(bool(torch.isfinite(t).all()) for t in (S1, S2, eta, G))
    gate(launches == {"score_c1": 2, "score_cn": 1, "cl_logits": 1,
                      "gram": 1} and pc == 0 and equal and types and finite,
         f"bf16 entries: family_score_stats (field grid, Potts paper graph),"
         f" score_stats_op, conditional_logits_op, gram_op launched "
         f"{launches}; plain calls on CUDA tensors {pc}; equal to the direct "
         f"calls {equal}; output types {types}; finite {finite}")
    del field, ff, pf, e1, r1, S1, e2, r2, S2, e3, r3, S3, eta, G, S16, G0
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, rows, errs


def phase18(torch, smi, gate, plain_cuda_calls, dev, prefill_shape,
            check_swa, time_swa) -> int:
    """recurrentgemma-2b at full width and depth (26 layers: eight
    rec/rec/attn units and two remainder RG-LRU layers), bf16 weights drawn
    on the card from a seeded generator: the swa kernel against its plain
    version at the model's two prefill shapes (width 256, 10/1 heads,
    window 2048; timed beside the plain version, SDPA with the band mask
    and the bound); generate at phase 8's shape twice (one launch an
    attention layer, no plain attention on a CUDA tensor, bitwise equal
    tokens) and at RG_LONG; prefill seconds, decode ms a step and peak
    memory at both; prefill and teacher-forced decode against one full
    forward (GATE_SERVE) at both; the attention caches' ring of 2048
    slots and the RG-LRU states; a profiled prefill at each shape (the
    device's busy share, the RG-LRU scan's share of device time, the swa
    kernel's device time); the reduced config (float32) on the card against
    the CPU. Returns the swa launches of the main-path runs."""
    import repro_torch.configs as TC
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import decoding as TD
    from repro_torch.models import ssm as TS
    from repro_torch.models import transformer as TT

    t_phase = time.perf_counter()
    cfg = TC.get("recurrentgemma-2b")
    arch = cfg.arch_id
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_attn = kinds.count("attn")
    h, kh, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    print(f"phase 18: {arch} at full width and depth ({cfg.n_layers} "
          f"layers: {cfg.n_units} units of {'/'.join(cfg.pattern)} and "
          f"{cfg.n_rem_layers} remainder layers; {kinds.count('rec')} RG-LRU "
          f"of width {cfg.rglru_width}, {n_attn} local attention with "
          f"{h}/{kh} heads at width {d} and window {w}; d={cfg.d_model}, "
          f"{cfg.dtype}) ({smi})", flush=True)
    requests = (prefill_shape, RG_LONG)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1800)
    for b, s_len, _ in requests:
        q = torch.randn((b, s_len, h, d), generator=gen, device=dev) \
            .to(torch.bfloat16)
        k, v = (torch.randn((b, s_len, kh, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        tag = f"{arch} prefill b={b} s={s_len} h/kh={h}/{kh} d={d} w={w}"
        check_swa(tag, q, k, v, w)
        time_swa(tag, q, k, v, w, 10 if s_len <= 2048 else 5)
        del q, k, v
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TT.model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_items(params)]
    print(f"  weights: {sum(t.numel() for t in leaves) / 1e9:.3f} B "
          f"parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} "
          f"GB, drawn on the card in {time.perf_counter() - t0:.2f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)
    del leaves
    prompts = [torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                             device=dev) for b, s_len, _ in requests]
    TD.generate(cfg, params, prompts[0][:1, :64], 2)    # warm-up
    torch.cuda.synchronize()
    total = 0

    def serve(prompt, n_new, label):
        nonlocal total
        smod.swa_attention.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = TD.generate(cfg, params, prompt, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl, pc = smod.swa_attention.launches, plain_cuda_calls["n"]
        total += nl
        gate(nl == n_attn and pc == 0
             and out.shape == (prompt.shape[0], n_new),
             f"{arch} {label}: generate {tuple(out.shape)} in {wall:.3f} s "
             f"({out.numel() / wall:.1f} tokens/s end to end); "
             f"flash-attention launches {nl} (one prefill of {n_attn} "
             f"attention layers), plain calls on CUDA tensors {pc}")
        return out

    def breakdown(prompt, n_new, label):
        """Prefill seconds and decode ms a step of the same request;
        returns the cache after the decode steps."""
        b, s_len = prompt.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TD.prefill(cfg, params, prompt, s_len + n_new)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        last = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        del logits
        step = TD.make_serve_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_new - 1):
            last, _, cache = step(params, cache, last, s_len + t)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / (n_new - 1)
        print(f"    {label}: prefill {t_pre:.4f} s ({b * s_len / t_pre:.0f} "
              f"prompt tokens/s), decode {1e3 * t_dec:.3f} ms per step "
              f"({b / t_dec:.1f} tokens/s at batch {b}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since "
              f"the request's first generate ({smi})", flush=True)
        gate(finite, f"{arch} {label}: prefill logits finite")
        return cache

    outs = []
    for (b, s_len, n_new), prompt in zip(requests, prompts):
        label = f"b={b} prompt={s_len}"
        torch.cuda.reset_peak_memory_stats()
        out = serve(prompt, n_new, label)
        if not outs:
            again = serve(prompt, n_new, label + ", again")
            gate(torch.equal(out, again), f"{arch}: greedy decoding gives "
                 f"identical tokens on a second run")
            del again
        outs.append(out)
        cache = breakdown(prompt, n_new, label)
        attn = cache["units"][f"b{cfg.pattern.index('attn')}"]["k"]
        rec = [c for c in cache["units"].values() if "h" in c] \
            + list(cache.get("rem", {}).values())
        gate(attn.shape[2] == min(w, s_len + n_new)
             and all(c["h"].dtype == torch.float32
                     and c["conv"].shape[-2] == cfg.conv_width - 1
                     and bool(torch.isfinite(c["h"]).all()) for c in rec),
             f"{arch} {label}: attention caches hold {attn.shape[2]} "
             f"positions (window {w}; decode wrote position "
             f"{s_len + n_new - 2} to slot {(s_len + n_new - 2) % w}); "
             f"RG-LRU states float32 and finite in {len(rec)} cache "
             f"groups")
        del cache

    for (b, s_len, _), prompt, out in zip(requests, prompts, outs):
        e_pre, e_dec, finite, _ = teacher_forced(torch, cfg, params, prompt,
                                                 out[:, :ZOO_EXTRA])
        gate(finite and e_pre <= GATE_SERVE and max(e_dec) <= GATE_SERVE,
             f"{arch} b={b} prompt={s_len}: prefill + teacher-forced decode "
             f"against one forward over {s_len + ZOO_EXTRA} tokens: rel "
             f"prefill {e_pre:.2e}, decode "
             + ", ".join(f"{e:.2e}" for e in e_dec))
        torch.cuda.empty_cache()

    for (b, s_len, n_new), prompt in zip(requests, prompts):
        _, by_name = marked_profile(
            torch, f"{arch} prefill b={b} prompt={s_len}",
            lambda: TD.prefill(cfg, params, prompt, s_len + n_new), TS,
            "linear_scan", "RG-LRU scan", "scans")
        us, n = map(sum, zip(*[v for name, v in by_name.items()
                               if "swa_" in name] or [(0.0, 0)]))
        print(f"    swa device time {us / 1e3 / max(n, 1):.4f} ms a launch "
              f"({n} launches in the profiled prefill)", flush=True)
        torch.cuda.empty_cache()
    del params, prompts, outs
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU (float32) ------
    red = TC.reduced(cfg)
    cgen = torch.Generator()
    cgen.manual_seed(18)
    on_cpu = TT.model_init(red, cgen, "cpu")
    on_card = _tree_to(on_cpu, dev)
    tok = torch.randint(0, red.vocab_size, (2, 100), generator=cgen)
    smod.swa_attention.launches = 0
    want, _ = TT.forward(red, on_cpu, tok)
    got, _ = TT.forward(red, on_card, tok.to(dev))
    nl = smod.swa_attention.launches
    e = rel_err(got.cpu(), want)
    same = torch.equal(TD.generate(red, on_card, tok[:, :80].to(dev), 8).cpu(),
                       TD.generate(red, on_cpu, tok[:, :80], 8))
    gate(e <= GATE_STATS and nl == red.n_units and same,
         f"reduced {arch} (float32) on the card against the CPU: logits rel "
         f"{e:.2e}, flash-attention launches {nl}, greedy tokens equal "
         f"{same}")
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase19(torch, smi, gate, plain_cuda_calls, dev, prefill_shape, timer,
            rates) -> None:
    """xlstm-1.3b at full width and depth (48 layers: six units of seven
    mLSTM and one sLSTM; d 2048, mLSTM width 4096 in 4 heads of 1024), bf16
    weights drawn on the card from a seeded generator: the mLSTM chunk scan
    against its chunk-1 recurrence on one layer's real inputs (b 1, 1024
    positions = 4 chunks, float32); each request (phase 8's shape and
    XL_LONG) through prefill and greedy decode steps (prefill seconds,
    decode ms a step and peak memory beside their bounds; no swa launch, no
    plain attention on a CUDA tensor), and at phase 8's shape generate
    twice (bitwise equal tokens, equal to the steps'); the (C, n, m) and
    sLSTM states; the bf16 prefill and teacher-forced decode against one
    full forward (reported), and the same in float32 over the first
    XL_F32_LAYERS layers (GATE_TF32); a profiled prefill at each shape, the
    long one cut to XL_PROFILED tokens (the device's busy share, the chunk
    scan's and the sLSTM position loop's shares of device time, no copy to
    the host); the reduced config (float32) on the card against the
    CPU."""
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import decoding as TD
    from repro_torch.models import transformer as TT
    from repro_torch.models import xlstm as TX
    from repro_torch.models.common import apply_norm

    t_phase = time.perf_counter()
    bw, flops, _ = rates
    cfg = TC.get("xlstm-1.3b")
    arch = cfg.arch_id
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_m, n_s = kinds.count("m"), kinds.count("s")
    du, nh, hd = TX._mlstm_dims(cfg)
    L, d = TX.MLSTM_CHUNK, cfg.d_model
    print(f"phase 19: {arch} at full width and depth ({cfg.n_layers} "
          f"layers: {cfg.n_units} units of {'/'.join(cfg.pattern)}; {n_m} "
          f"mLSTM of width {du} in {nh} heads of {hd}, chunk {L}; {n_s} "
          f"sLSTM of width {d}; {cfg.dtype}) ({smi})", flush=True)
    requests = (prefill_shape, XL_LONG)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1900)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TT.model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_items(params)]
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"  weights: {sum(t.numel() for t in leaves) / 1e9:.3f} B "
          f"parameters, {weight_bytes / 1e9:.3f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)
    del leaves

    # ---- the chunk scan against its chunk-1 recurrence --------------------
    # the inputs of the first mLSTM layer's scan over a 1024-token prompt
    captured, scan = [], TX._mlstm_chunk_scan

    def capture(*args):
        captured.extend(a.clone() for a in args)
        return scan(*args)

    p0 = TT._layer(params["units"], 0)["b0"]
    tok = torch.randint(0, cfg.vocab_size, (1, 4 * L), generator=gen,
                        device=dev)
    TX._mlstm_chunk_scan = capture
    try:
        with torch.no_grad():
            TX.mlstm_apply(cfg, p0["mix"], apply_norm(cfg, p0["norm1"],
                                                      params["embed"][tok]))
    finally:
        TX._mlstm_chunk_scan = scan
    inputs = captured[:5]
    h, state = scan(*inputs)
    TX.MLSTM_CHUNK = 1
    try:
        t0 = time.perf_counter()
        h1, state1 = scan(*inputs)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        TX.MLSTM_CHUNK = L
    errs = [rel_err(a, c) for a, c in zip((h,) + state, (h1,) + state1)]
    gate(h.dtype == torch.float32 and max(errs) <= GATE_SCAN,
         f"{arch} mLSTM chunk scan at one layer's inputs (b=1 h={nh} "
         f"s={4 * L} d={hd}: 4 chunks of {L}, float32, TF32 off) against "
         f"the chunk-1 recurrence: rel h {errs[0]:.2e}, C {errs[1]:.2e}, n "
         f"{errs[2]:.2e}, m {errs[3]:.2e} (gate {GATE_SCAN:.0e})")

    def scan_flop(b, s_len):
        """The chunk scan's products a layer: q k^T and S v within each
        chunk, q C and k^T v across."""
        return (s_len // L) * (4 * b * nh * L * L * hd
                               + 4 * b * nh * L * hd * hd)

    ms = timer(lambda: scan(*inputs), 10)
    print(f"  time mLSTM chunk scan b=1 s={4 * L}: {ms:.4f} ms (chunk-1 "
          f"recurrence {step_ms:.1f} ms, one host-timed call); bound "
          f"{1e3 * scan_flop(1, 4 * L) / flops:.4f} ms "
          f"({scan_flop(1, 4 * L) / 1e9:.1f} GFLOP at FP32) ({smi})",
          flush=True)
    del captured, inputs, h, state, h1, state1, tok
    torch.cuda.empty_cache()

    prompts = [torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                             device=dev) for b, s_len, _ in requests]
    TD.generate(cfg, params, prompts[0][:1, :64], 2)    # warm-up
    torch.cuda.synchronize()
    r_bytes = d * 4 * d * 2                  # one sLSTM layer's r_gates, bf16
    embed_bytes = params["embed"].numel() * params["embed"].element_size()

    def bounds(b, s_len):
        """Prefill's chunk scans and sLSTM loop, and a decode step, at
        their least times on this card."""
        fl = n_m * scan_flop(b, s_len)
        steps = n_s * s_len
        c_bytes = n_m * b * nh * hd * hd * 4
        dec = weight_bytes - embed_bytes + 2 * c_bytes
        print(f"    bounds b={b} s={s_len}: chunk scans {fl / 1e12:.2f} "
              f"TFLOP FP32 = {fl / flops:.4f} s; sLSTM loop {steps} steps "
              f"reading r_gates ({r_bytes / 1e6:.1f} MB bf16) once a step = "
              f"{steps * r_bytes / bw:.4f} s; a decode step reads "
              f"{(weight_bytes - embed_bytes) / 1e9:.2f} GB of weights and "
              f"reads and writes {c_bytes / 1e9:.2f} GB of float32 C = "
              f"{1e3 * dec / bw:.3f} ms ({smi})", flush=True)

    def counts():
        nl, pc = smod.swa_attention.launches, plain_cuda_calls["n"]
        smod.swa_attention.launches = 0
        plain_cuda_calls["n"] = 0
        return nl, pc

    def serve(prompt, n_new, label):
        counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = TD.generate(cfg, params, prompt, n_new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl, pc = counts()
        gate(nl == 0 and pc == 0 and out.is_cuda
             and out.shape == (prompt.shape[0], n_new),
             f"{arch} {label}: generate {tuple(out.shape)} in {wall:.3f} s "
             f"({out.numel() / wall:.1f} tokens/s end to end; {smi}); "
             f"flash-attention launches {nl}, plain attention calls on CUDA "
             f"tensors {pc}, tokens on {out.device}")
        return out

    def breakdown(prompt, n_new, label):
        """The request through prefill and greedy decode steps, as
        generate runs them: prefill seconds and decode ms a step; returns
        (tokens, prefill logits, the first ZOO_EXTRA steps' logits, the
        cache after the steps)."""
        b, s_len = prompt.shape
        counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TD.prefill(cfg, params, prompt, s_len + n_new)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        out = [torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]]
        steps = []
        step = TD.make_serve_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_new - 1):
            nxt, lg, cache = step(params, cache, out[-1], s_len + t)
            out.append(nxt)
            if len(steps) < ZOO_EXTRA:
                steps.append(lg[:, 0])
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / (n_new - 1)
        nl, pc = counts()
        out = torch.cat(out, 1)
        print(f"    {label}: prefill {t_pre:.4f} s ({b * s_len / t_pre:.0f} "
              f"prompt tokens/s), decode {1e3 * t_dec:.3f} ms per step "
              f"({b / t_dec:.1f} tokens/s at batch {b}); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since "
              f"the request's first prefill ({smi})", flush=True)
        gate(finite and nl == 0 and pc == 0 and out.is_cuda,
             f"{arch} {label}: prefill logits finite; prefill and "
             f"{n_new - 1} decode steps launched swa {nl} times, plain "
             f"attention on CUDA tensors {pc} times; tokens on {out.device}")
        return out, logits, steps, cache

    def forward_at(cfg_, params_, tok):
        """The full forward over ``tok`` padded with zero tokens to a
        length the chunk divides (the logits at tok's positions do not
        depend on them)."""
        pad = -tok.shape[1] % L
        with torch.no_grad():
            return TT.forward(cfg_, params_, torch.cat(
                [tok, tok.new_zeros((tok.shape[0], pad))], 1))[0]

    outs = []
    for (b, s_len, n_new), prompt in zip(requests, prompts):
        label = f"b={b} prompt={s_len}"
        torch.cuda.reset_peak_memory_stats()
        out, logits, steps, cache = breakdown(prompt, n_new, label)
        bounds(b, s_len)
        if not outs:
            # the user's entry point, twice, against the breakdown's tokens
            first = serve(prompt, n_new, label)
            again = serve(prompt, n_new, label + ", again")
            gate(torch.equal(first, again) and torch.equal(first, out),
                 f"{arch}: greedy decoding gives identical tokens on a second"
                 f" run and through prefill + make_serve_step")
            del first, again
        outs.append(out)
        groups = cache["units"]
        m_ok = all(groups[f"b{i}"][key].dtype == torch.float32
                   and groups[f"b{i}"][key].is_cuda
                   and bool(torch.isfinite(groups[f"b{i}"][key]).all())
                   for i, kind in enumerate(cfg.pattern)
                   for key in (("C", "n", "m") if kind == "m" else "cnmh"))
        C = groups["b0"]["C"]
        c_gb = C.numel() * 4 * (n_m // cfg.n_units) / 1e9
        gate(m_ok and C.shape == (cfg.n_units, b, nh, hd, hd)
             and groups["b0"]["conv"].shape[-2] == cfg.conv_width - 1,
             f"{arch} {label}: mLSTM (C, n, m) and sLSTM (c, n, m, h) "
             f"states float32, finite and on the card; C {tuple(C.shape)} "
             f"({c_gb:.2f} GB over the {n_m} mLSTM layers)")
        del cache, C, groups
        # bf16 prefill and teacher-forced decode against one forward:
        # reported, gated in float32 (see XL_F32_LAYERS)
        tok = torch.cat([prompt, out[:, :ZOO_EXTRA]], 1)
        ref = forward_at(cfg, params, tok)
        e_pre = rel32(logits, ref[:, :s_len])
        e_dec = [rel32(lg, ref[:, s_len + t]) for t, lg in enumerate(steps)]
        gate(bool(torch.isfinite(ref).all()),
             f"{arch} {label}: forward over {ref.shape[1]} tokens finite; "
             f"bf16 prefill against it rel {e_pre:.2e}, teacher-forced "
             f"decode " + ", ".join(f"{e:.2e}" for e in e_dec)
             + " (reported, not gated)")
        del logits, steps, ref, tok
        torch.cuda.empty_cache()

    # ---- float32 teacher-forced decode over XL_F32_LAYERS layers ---------
    for (b, s_len, _), prompt, out, layers in zip(requests, prompts, outs,
                                                   XL_F32_LAYERS):
        units = layers // len(cfg.pattern)
        c32 = dataclasses.replace(cfg, dtype="float32", n_layers=layers)
        p32 = _tree_to({k: v for k, v in params.items() if k != "units"},
                       torch.float32)
        p32["units"] = _tree_to(
            {slot: {g: {k: v[:units] for k, v in leaves.items()}
                    for g, leaves in group.items()}
             for slot, group in params["units"].items()}, torch.float32)
        pad = -(s_len + ZOO_EXTRA) % L
        e_pre, e_dec, finite, _ = teacher_forced(
            torch, c32, p32, prompt, out[:, :ZOO_EXTRA], pad=pad)
        gate(finite and max([e_pre] + e_dec) <= GATE_TF32,
             f"{arch} float32, {layers} layers, b={b} prompt={s_len}: "
             f"prefill + teacher-forced decode against one forward over "
             f"{s_len + ZOO_EXTRA + pad} tokens: rel prefill {e_pre:.2e}, "
             f"decode " + ", ".join(f"{e:.2e}" for e in e_dec)
             + f" (gate {GATE_TF32:.0e})")
        del p32
        torch.cuda.empty_cache()

    # the long request's profile at XL_PROFILED tokens (b = 1)
    for (b, s_len, n_new), prompt in zip(requests, prompts):
        if b == 1:
            s_len, prompt = XL_PROFILED, prompt[:, :XL_PROFILED]
        _, by_name = marked_profile(
            torch, f"{arch} prefill b={b} prompt={s_len}",
            lambda: TD.prefill(cfg, params, prompt, s_len + n_new), TX,
            "_mlstm_chunk_scan", "mLSTM chunk scan", "scans",
            more=((TX, "_slstm_scan", "sLSTM position loop", "loops"),))
        to_host = sum(n for name, (_, n) in by_name.items()
                      if "DtoH" in name)
        swa = sum(n for name, (_, n) in by_name.items() if "swa_" in name)
        gate(to_host == 0 and swa == 0,
             f"{arch} profiled prefill b={b} prompt={s_len}: copies to the "
             f"host {to_host}, swa kernels {swa} ({smi})")
        torch.cuda.empty_cache()
    del params, prompts, outs
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU (float32) ------
    red = TC.reduced(cfg)
    cgen = torch.Generator()
    cgen.manual_seed(19)
    on_cpu = TT.model_init(red, cgen, "cpu")
    on_card = _tree_to(on_cpu, dev)
    tok = torch.randint(0, red.vocab_size, (2, 100), generator=cgen)
    smod.swa_attention.launches = 0
    want, _ = TT.forward(red, on_cpu, tok)
    got, _ = TT.forward(red, on_card, tok.to(dev))
    nl = smod.swa_attention.launches
    e = rel_err(got.cpu(), want)
    same = torch.equal(TD.generate(red, on_card, tok[:, :80].to(dev), 8).cpu(),
                       TD.generate(red, on_cpu, tok[:, :80], 8))
    gate(e <= GATE_STATS and nl == 0 and same,
         f"reduced {arch} (float32) on the card against the CPU: logits rel "
         f"{e:.2e}, flash-attention launches {nl}, greedy tokens equal "
         f"{same}")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase20(torch, smi, gate, plain_cuda_calls, dev, timer, rates,
            check_swa, time_swa) -> int:
    """whisper-tiny at full width and depth (4 encoder and 4 decoder
    layers, d 384, 6 heads of 64, 1500 frames, vocab 51865 padded to
    52096), bf16 weights and frame embeddings drawn on the card from a
    seeded generator: the swa kernel against its plain version at both
    prefill shapes (width 64, 6/6 heads, no window; bf16 and float32),
    timed beside plain, SDPA and the bound at WH_REQUEST's; generate at
    WH_REQUEST twice (bitwise equal tokens, one swa launch a decoder layer
    in the prefill, none in a decode step, no causal plain attention on a
    CUDA tensor, the non-causal plain calls counted: every encoder and
    cross-attention layer of a forward, every cross-attention layer of a
    step) and at WH_FIRST; encode ms, prefill seconds, decode ms a step and
    peak memory beside their bounds; prefill and teacher-forced decode
    against one full forward in bf16 (GATE_SERVE) and in float32 at full
    depth (GATE_TF32); a profiled prefill at each request (busy share, the
    encoder's and the non-causal attention's shares of device time, the
    swa kernel's device time), a profiled encoder (its plain attention's
    share) and WH_PROFILED_STEPS profiled decode steps (the
    cross-attention's share, its K and V projected from the encoder's
    output every step); the encoder and cross-attention at full width in
    float32 on the card against the CPU, and the reduced config on the
    card against the CPU. Returns the swa launches of the main-path
    runs."""
    import dataclasses

    import repro_torch.configs as TC
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import attention as TA
    from repro_torch.models import decoding as TD
    from repro_torch.models import transformer as TT

    t_phase = time.perf_counter()
    bw, _, bf16_flops = rates
    cfg = TC.get("whisper-tiny")
    arch = cfg.arch_id
    L, Le = cfg.n_layers, cfg.n_enc_layers
    h, kh, hd, d, dff = (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model,
                         cfg.d_ff)
    vp = cfg.padded_vocab
    print(f"phase 20: {arch} at full width and depth ({Le} encoder and {L} "
          f"decoder layers, d={d}, {h}/{kh} heads of {hd}, d_ff={dff}, "
          f"{cfg.n_frames} frames, vocab {cfg.vocab_size} padded to {vp}; "
          f"{cfg.dtype}) ({smi})", flush=True)
    requests = (WH_REQUEST, WH_FIRST)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2000)
    for b, _, s_len, _ in requests:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s_len, h, hd), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((b, s_len, kh, hd), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            tag = f"{arch} prefill b={b} s={s_len} h/kh={h}/{kh} d={hd}"
            check_swa(tag, q, k, v, 0)
            if s_len == WH_REQUEST[2] and dtype == torch.bfloat16:
                time_swa(tag, q, k, v, 0, 50)
            del q, k, v

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TT.model_init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_items(params)]
    print(f"  weights: {sum(t.numel() for t in leaves) / 1e6:.3f} M "
          f"parameters, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e6:.1f} "
          f"MB, drawn on the card in {time.perf_counter() - t0:.2f} s",
          flush=True)
    del leaves
    b0, n_frames = WH_REQUEST[:2]
    frames = torch.randn((b0, n_frames, d), generator=gen,
                         device=dev).to(cfg.torch_dtype)
    prompts = [torch.randint(0, cfg.vocab_size, (b, s_len), generator=gen,
                             device=dev) for b, _, s_len, _ in requests]
    TD.generate(cfg, params, prompts[1][:1], 2, enc_frames=frames[:1])

    def bounds(b, F, s_len, n_new):
        """Least ms of the encoder, a prefill (the encoder included) and a
        mean decode step on this card, bf16: the larger of the bytes that
        must move (weights, frames, logits, the KV cache written or read,
        the encoder's output a step reads) over the memory rate and the
        products over the BF16 peak."""
        enc_w = Le * (4 * d * d + 2 * d * dff) * 2
        dec_w = L * (8 * d * d + 2 * d * dff) * 2
        head = d * vp * 2
        enc_fl = Le * (2 * b * F * (4 * d * d + 2 * d * dff)
                       + 4 * b * h * F * F * hd)
        cross_kv = 2 * b * F * 2 * d * d
        pre_fl = enc_fl + L * (2 * b * s_len * (6 * d * d + 2 * d * dff)
                               + cross_kv
                               + 2 * b * h * hd * s_len * (s_len + 1)
                               + 4 * b * h * s_len * F * hd) \
            + 2 * b * s_len * d * vp
        t = s_len + n_new / 2         # keys a mean step attends to
        dec_fl = L * (2 * b * (6 * d * d + 2 * d * dff) + cross_kv
                      + 4 * b * h * hd * t + 4 * b * h * F * hd) \
            + 2 * b * d * vp
        act = b * F * d * 2
        enc_by = enc_w + 2 * act
        pre_by = enc_w + dec_w + head + act + b * s_len * vp * 2 \
            + L * 2 * b * s_len * d * 2
        dec_by = dec_w + head + act + L * 2 * b * t * d * 2 + b * vp * 2
        out = {name: 1e3 * max(by / bw, fl / bf16_flops)
               for name, by, fl in (("encode", enc_by, enc_fl),
                                    ("prefill", pre_by, pre_fl),
                                    ("decode", dec_by, dec_fl))}
        # a step's cross K/V as the port computes them: read the encoder's
        # output, write K and V, read them back, in every decoder layer
        out.update(kv_flop_share=cross_kv * L / dec_fl,
                   kv_mb=L * 5 * act / 1e6, dec_mb=dec_by / 1e6)
        return out

    total = 0
    with counting_calls(TA, "_full_attention") as full:
        def counts():
            out = (smod.swa_attention.launches, plain_cuda_calls["n"],
                   full["n"])
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            full["n"] = 0
            return out

        def serve(prompt, n_new, label):
            nonlocal total
            b, s_len = prompt.shape
            counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = TD.generate(cfg, params, prompt, n_new, enc_frames=frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            nl, pc, nf = counts()
            total += nl
            # generate encodes once for the steps; the prefill's forward
            # encodes again and attends across; each step attends across
            want_nf = Le + (Le + L) + L * (n_new - 1)
            gate(nl == L and pc == 0 and nf == want_nf
                 and out.shape == (b, n_new),
                 f"{arch} {label}: generate {tuple(out.shape)} in "
                 f"{wall:.3f} s ({out.numel() / wall:.1f} tokens/s end to "
                 f"end; {smi}); flash-attention launches {nl} (one prefill "
                 f"of {L} decoder layers), causal plain attention on CUDA "
                 f"tensors {pc}, non-causal plain attention calls {nf} "
                 f"({Le} encoder layers in generate, {Le} + {L} in the "
                 f"prefill, {L} in each of {n_new - 1} steps)")
            return out

        def breakdown(prompt, n_new, label, base):
            """Encode ms, prefill seconds and decode ms a step of the
            request beside their bounds, with the launches of the prefill
            and of the steps counted apart; the peak memory above
            ``base``, what was allocated before the request."""
            b, s_len = prompt.shape
            bd = bounds(b, n_frames, s_len, n_new)
            enc_ms = timer(lambda: TT.encode(cfg, params, frames), 10)
            counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = TD.prefill(cfg, params, prompt, s_len + n_new,
                                       enc_frames=frames)
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            pre = counts()
            finite = bool(torch.isfinite(logits).all())
            last = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            del logits
            enc_out = TT.encode(cfg, params, frames)
            counts()
            step = TD.make_serve_step(cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(n_new - 1):
                last, _, cache = step(params, cache, last, s_len + t,
                                      enc_out)
            torch.cuda.synchronize()
            t_dec = (time.perf_counter() - t0) / (n_new - 1)
            dec = counts()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            kshape = tuple(cache["units"]["b0"]["k"].shape)
            print(f"    {label}: encode {enc_ms:.4f} ms (bound "
                  f"{bd['encode']:.4f} ms), prefill {t_pre:.4f} s (bound "
                  f"{bd['prefill'] / 1e3:.6f} s; {b * s_len / t_pre:.0f} "
                  f"prompt tokens/s), decode {1e3 * t_dec:.3f} ms per step "
                  f"(bound {bd['decode']:.4f} ms over {bd['dec_mb']:.1f} "
                  f"MB; the cross K/V recompute is "
                  f"{100 * bd['kv_flop_share']:.1f}% of a step's products "
                  f"and moves {bd['kv_mb']:.1f} MB as computed; "
                  f"{b / t_dec:.1f} tokens/s at batch {b}); peak device "
                  f"memory {peak:.2f} GiB above the {base / 2**30:.2f} "
                  f"GiB held before the "
                  f"request's first generate ({smi})", flush=True)
            gate(finite and pre[:2] == (L, 0) and pre[2] == Le + L
                 and dec[:2] == (0, 0) and dec[2] == L * (n_new - 1)
                 and kshape == (L, b, s_len + n_new, kh, hd),
                 f"{arch} {label}: prefill logits finite; the prefill "
                 f"launched swa {pre[0]} times and plain non-causal "
                 f"attention {pre[2]} times, {n_new - 1} decode steps swa "
                 f"{dec[0]} times and non-causal {dec[2]} times; causal "
                 f"plain attention on CUDA tensors {pre[1] + dec[1]}; the "
                 f"self-attention cache {kshape}")
            del cache, enc_out

        outs = []
        for (b, _, s_len, n_new), prompt in zip(requests, prompts):
            label = f"b={b} frames={n_frames} prompt={s_len}"
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = serve(prompt, n_new, label)
            if not outs:
                again = serve(prompt, n_new, label + ", again")
                gate(torch.equal(out, again), f"{arch}: greedy decoding "
                     f"gives identical tokens on a second run")
                del again
            outs.append(out)
            breakdown(prompt, n_new, label, base)
            torch.cuda.empty_cache()

        # prefill + teacher-forced decode against one forward: bf16 under
        # GATE_SERVE, float32 at full depth under GATE_TF32
        c32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _tree_to(params, torch.float32)
        for (b, _, s_len, _), prompt, out in zip(requests, prompts, outs):
            for c, p, fr, tol in ((cfg, params, frames, GATE_SERVE),
                                  (c32, p32, frames.float(), GATE_TF32)):
                e_pre, e_dec, finite, _ = teacher_forced(
                    torch, c, p, prompt, out[:, :ZOO_EXTRA], enc_frames=fr)
                gate(finite and max([e_pre] + e_dec) <= tol,
                     f"{arch} {c.dtype} b={b} prompt={s_len}: prefill + "
                     f"teacher-forced decode against one forward over "
                     f"{s_len + ZOO_EXTRA} tokens: rel prefill {e_pre:.2e}, "
                     f"decode " + ", ".join(f"{e:.2e}" for e in e_dec)
                     + f" (gate {tol:.0e})")
            torch.cuda.empty_cache()

        for (b, _, s_len, n_new), prompt in zip(requests, prompts):
            _, by_name = marked_profile(
                torch, f"{arch} prefill b={b} prompt={s_len}",
                lambda: TD.prefill(cfg, params, prompt, s_len + n_new,
                                   enc_frames=frames), TT, "encode",
                "encoder", "encodes",
                more=((TA, "_full_attention", "non-causal plain attention",
                       "calls"),))
            us, n = map(sum, zip(*[v for name, v in by_name.items()
                                   if "swa_" in name] or [(0.0, 0)]))
            print(f"    swa device time {us / 1e3 / max(n, 1):.4f} ms a "
                  f"launch ({n} launches in the profiled prefill)",
                  flush=True)
        marked_profile(torch, f"{arch} encoder b={b0} frames={n_frames}",
                       lambda: TT.encode(cfg, params, frames), TA,
                       "_full_attention", "encoder plain attention", "calls")

        # WH_PROFILED_STEPS decode steps of WH_REQUEST after its prefill
        b, _, s_len, n_new = WH_REQUEST
        _, cache = TD.prefill(cfg, params, prompts[0], s_len + n_new,
                              enc_frames=frames)
        enc_out = TT.encode(cfg, params, frames)
        step = TD.make_serve_step(cfg)
        last = prompts[0][:, -1:]

        def steps():
            nonlocal last, cache
            for t in range(WH_PROFILED_STEPS):
                last, _, cache = step(params, cache, last, s_len + t, enc_out)
        marked_profile(torch, f"{arch} {WH_PROFILED_STEPS} decode steps "
                       f"b={b} from position {s_len}", steps, TA,
                       "cross_apply", "cross-attention (K/V projected anew)",
                       "calls")
        del cache, enc_out
        del params, prompts, outs
        torch.cuda.empty_cache()

        # ---- the encoder and cross-attention at full width on the card
        # against the CPU (float32, b = 1) ----------------------------------
        on_cpu = _tree_to(p32, "cpu")
        fr = frames[:1].float()
        counts()
        enc_card = TT.encode(c32, p32, fr)
        cross = TT._layer(p32["units"], 0)["b0"]["cross"]
        x = torch.randn((1, WH_REQUEST[2], d), generator=gen, device=dev)
        got = TA.cross_apply(c32, cross, x, enc_card)
        nl, pc, nf = counts()
        enc_cpu = TT.encode(c32, on_cpu, fr.cpu())
        want = TA.cross_apply(c32, TT._layer(on_cpu["units"], 0)["b0"]
                              ["cross"], x.cpu(), enc_cpu)
        e_enc, e_cross = rel_err(enc_card.cpu(), enc_cpu), \
            rel_err(got.cpu(), want)
        gate(max(e_enc, e_cross) <= GATE_STATS and nl == 0 and pc == 0
             and nf == Le + 1,
             f"{arch} float32 encoder (b=1, {n_frames} frames) and layer 0's "
             f"cross-attention ({WH_REQUEST[2]} queries) on the card against "
             f"the CPU: rel {e_enc:.2e} and {e_cross:.2e}; swa launches "
             f"{nl}, non-causal plain calls {nf}")
        del p32, on_cpu, enc_card, enc_cpu, got, want, frames
        torch.cuda.empty_cache()

        # ---- the reduced config on the card against the CPU (float32) --
        red = TC.reduced(cfg)
        cgen = torch.Generator()
        cgen.manual_seed(20)
        on_cpu = TT.model_init(red, cgen, "cpu")
        on_card = _tree_to(on_cpu, dev)
        tok = torch.randint(0, red.vocab_size, (2, 100), generator=cgen)
        fr = torch.randn((2, red.n_frames, red.d_model), generator=cgen)
        counts()
        want, _ = TT.forward(red, on_cpu, tok, enc_frames=fr)
        got, _ = TT.forward(red, on_card, tok.to(dev), enc_frames=fr.to(dev))
        nl, pc, nf = counts()
        e = rel_err(got.cpu(), want)
        same = torch.equal(
            TD.generate(red, on_card, tok[:, :80].to(dev), 8,
                        enc_frames=fr.to(dev)).cpu(),
            TD.generate(red, on_cpu, tok[:, :80], 8, enc_frames=fr))
        gate(e <= GATE_STATS and nl == red.n_layers and pc == 0
             and nf == red.n_enc_layers + red.n_layers and same,
             f"reduced {arch} (float32) on the card against the CPU: logits "
             f"rel {e:.2e}, flash-attention launches {nl}, non-causal plain "
             f"calls {nf}, greedy tokens equal {same}")
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def swa_pairs(s, window):
    """(query, key) pairs in the causal band of one head."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def check_swa_function(torch, gate, tag, q, k, v, g, window=0,
                       v_width=None):
    """The swa autograd Function (``swa_op`` on tensors that need
    gradients) against plain autograd of the plain version: dq, dk, dv
    bitwise, one kernel launch for the forward, the forward within GATE_SWA
    of the plain version in float32, and V's zero padding past ``v_width``
    zero in the output."""
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.kernels.swa import ops as sops

    n0 = smod.swa_attention.launches
    out = sops.swa_op(q, k, v, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    n_fwd = smod.swa_attention.launches - n0
    want = torch.autograd.grad(
        smod.swa_attention_ref(q, k, v, window=window), (q, k, v), g)
    with torch.no_grad():
        ref32 = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                       window=window)
    torch.cuda.synchronize()
    same = all(torch.equal(a, w) for a, w in zip(got, want))
    e = rel_err(out.detach(), ref32)
    padded = v_width is not None and v_width < q.shape[-1]
    gate(same and e <= GATE_SWA[str(q.dtype).split(".")[-1]] and n_fwd == 1
         and not (padded and out[..., v_width:].any()),
         f"swa Function {tag}: dq, dk, dv bitwise equal to plain "
         f"autograd {same}; forward rel {e:.2e} against the plain "
         f"version in float32; kernel launches {n_fwd}"
         + ("; V's padding zero in the output" if padded else ""))


def time_swa_training(torch, timer, bf16_flops, tag, q, k, v, g, window=0):
    """The kernel forward, the plain-recompute backward, SDPA's forward
    and backward (``is_causal``, or the band mask for a window), and the
    bounds of a flash forward and backward (operations at BF16)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels.swa import kernel as smod

    def recompute():
        torch.autograd.grad(smod.swa_attention_ref(q, k, v, window=window),
                            (q, k, v), g)

    def kernel_fwd():
        with torch.no_grad():
            smod.swa_attention(q, k, v, window=window)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    gt = g.transpose(1, 2)
    b_, s_, h_, d_ = q.shape
    mask = {"is_causal": True}
    if window:
        pos = torch.arange(s_, device=q.device)
        mask = {"attn_mask": (pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window)}

    def library():
        torch.autograd.grad(Fn.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **mask), (qt, kt, vt), gt)
    rec_ms = timer(recompute, 5)
    fwd_ms = timer(kernel_fwd, 10)
    lib_ms = timer(library, 10)
    fwd_bound = 4 * d_ * swa_pairs(s_, window) * b_ * h_ / bf16_flops * 1e3
    print(f"  swa training {tag}: kernel forward {fwd_ms:.4f} ms "
          f"(bound {fwd_bound:.4f}, operations), backward by plain "
          f"recompute {rec_ms:.4f} ms a layer, a flash backward's bound "
          f"{2.5 * fwd_bound:.4f} ms (operations); sdpa "
          + ("with the band mask " if window else "") + f"forward and "
          f"backward {lib_ms:.4f} ms", flush=True)


def training_profile(torch, label: str, fn, pieces=()):
    """One call of ``fn`` (a train step) under torch.profiler: prints the
    device's busy share and the shares of its device time in the plain
    attention recompute (a record_function range around
    ``SwaFunction.backward``) and in each of ``pieces``, (module, function
    name, range name) of a function the step calls (the expert layer's
    dispatch, expert products and combine; the AdamW update), and returns
    what ``fn`` returned.

    A piece's forward calls (the step's forward and the remat recompute)
    run inside a range around the call. Its backward runs inside a range
    that two identity autograd Functions open and close: one on the piece's
    first output opens it when the gradient reaches that output, one on the
    first input that needs a gradient closes it when the gradient leaves.
    The engine runs the nodes made between the two, the piece's own, in
    between (it takes the ready node made last first). A piece may carry a
    fourth element, ``closes_at(args, wrap) -> args``, which applies
    ``wrap`` to the input whose gradient closes the range instead (the
    encoder's position table: its frames take no gradient)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels.swa import ops as sops

    class Opens(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, name, stack):
            ctx.name, ctx.stack = name, stack
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            rf = record_function(ctx.name)
            rf.__enter__()
            ctx.stack.append(rf)
            return g, None, None

    class Closes(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, stack):
            ctx.stack = stack
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if ctx.stack:
                ctx.stack.pop().__exit__(None, None, None)
            return g, None

    def first_input(args, wrap):
        i = next((j for j, a in enumerate(args)
                  if isinstance(a, torch.Tensor) and a.requires_grad), None)
        if i is not None:
            args[i] = wrap(args[i])
        return args

    def marked(plain, name, closes_at=first_input):
        stack = []

        def call(*args):
            with record_function(name):
                wrapped = []

                def wrap(t):
                    wrapped.append(t)
                    return Closes.apply(t, stack)
                args = list(args)
                if torch.is_grad_enabled():
                    args = closes_at(args, wrap)
                out = plain(*args)
                if wrapped:
                    if isinstance(out, tuple):
                        out = (Opens.apply(out[0], name, stack),) + out[1:]
                    else:
                        out = Opens.apply(out, name, stack)
            return out
        return call

    recompute = "swa_backward_recompute"
    names = [recompute] + [piece[2] for piece in pieces]
    plain = [getattr(piece[0], piece[1]) for piece in pieces]
    backward = sops.SwaFunction.backward

    def traced(ctx, g):
        with record_function(recompute):
            return backward(ctx, g)
    sops.SwaFunction.backward = staticmethod(traced)
    for piece, f in zip(pieces, plain):
        setattr(piece[0], piece[1], marked(f, *piece[2:]))
    t_all = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        sops.SwaFunction.backward = backward
        for piece, f in zip(pieces, plain):
            setattr(piece[0], piece[1], f)
    busy, kernel_ns, marked_ns, by_name, n_events = range_shares(
        torch, prof, names)
    shares = [f"{n} {marked_ns[n][0] / 1e6:.1f} ms over {marked_ns[n][1]} "
              f"ranges = {100 * marked_ns[n][0] / max(kernel_ns, 1):.1f}%"
              for n in names]
    print(f"  profiled {label}: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%, under the profiler); "
          f"{'; '.join(shares)} of {kernel_ns / 1e6:.1f} ms of device time "
          f"({n_events} events; {time.perf_counter() - t_all:.1f} s with the "
          f"trace's read-back)", flush=True)
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"    device {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    return out


def phase21(torch, np, smi, gate, plain_cuda_calls, dev, timer,
            bf16_flops) -> int:
    """Training of the attention families on the card: the swa autograd
    Function at width 96 (TRAIN_SWA96: minicpm3's MLA, 40/40 heads, V
    zero-padded from 64; bf16 and float32) against plain autograd
    (bitwise gradients, one forward launch) and ``_kernel_attention`` at
    the reduced MLA width 48 padded to 64 (float32, against plain autograd
    at 48 within GATE_SWA); the forward, the plain-recompute backward, a
    flash backward's bound and SDPA's forward and backward timed at width
    96 and at qwen2-moe's 16/16 heads of 128; the router's stable sort
    timed beside torch.topk at phase 16's qwen2-moe prefill (8192 tokens,
    60 experts); TRAIN_FAMILIES (minicpm3 and qwen2-moe at full width,
    depth cut, random bf16 weights drawn on the card) for their steps on
    one fixed batch: loss, nll and aux finite, nll falling, two swa
    launches a layer a step and one plain recompute, step wall, tokens/s
    and peak memory above what the phase found held, beside the step's
    bound; the capacity path's dropped share; one step's gradients
    repeated from one state bitwise; qwen2-moe's padding experts at
    exactly zero gradient and its router's gradient finite and non-zero;
    a profiled step (busy share, the recompute's share, the dispatch's,
    expert products', combine's and the AdamW update's); then one sync
    step of each of ZOO's reduced configs (float32; llama4-scout with its
    patch embeddings) on the card against the CPU under phase 15's gates.
    Returns the swa launches of the trained models' steps."""
    import dataclasses

    import torch.nn.functional as Fn

    import repro_torch.configs as TC
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import attention as TA
    from repro_torch.models import moe as TM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as TS

    t_phase = time.perf_counter()
    print(f"phase 21: training the attention families ({smi})", flush=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2100)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- the autograd Function at the new widths ------------------------
    b, s_len, h, d, dv = TRAIN_SWA96
    cases = ((torch.bfloat16, (b, s_len, h, h, d), dv),
             (torch.float32, (b, TRAIN_SWA_F32[1], h, h, d), dv),
             (torch.bfloat16, (4, 2048, 16, 16, 128), 128))
    for dtype, (b_, s_, h_, kh_, d_), dv_ in cases:
        q = randn((b_, s_, h_, d_), dtype).requires_grad_(True)
        k = randn((b_, s_, kh_, d_), dtype).requires_grad_(True)
        v = Fn.pad(randn((b_, s_, kh_, dv_), dtype),
                   (0, d_ - dv_)).requires_grad_(True)
        g = randn((b_, s_, h_, d_), dtype)
        name = str(dtype).split(".")[-1]
        tag = (f"b={b_} s={s_} h/kh={h_}/{kh_} d={d_}"
               + (f" (V padded from {dv_})" if dv_ < d_ else "") + f" {name}")
        check_swa_function(torch, gate, tag, q, k, v, g, v_width=dv_)
        if dtype == torch.bfloat16:
            time_swa_training(torch, timer, bf16_flops, tag, q, k, v, g)
        del q, k, v, g
        torch.cuda.empty_cache()

    b4, s4, h4 = TRAIN_PAD48
    q, k, v, g = (randn((b4, s4, h4, 48), torch.float32) for _ in range(4))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = smod.swa_attention.launches
    out = TA._kernel_attention(*ins, window=0)
    got = torch.autograd.grad(out, ins, g)
    n_fwd = smod.swa_attention.launches - n0
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = TA._plain_attention(*plain, window=0)
    want = torch.autograd.grad(ref, plain, g)
    errs = [rel_err(out.detach(), ref.detach())] + [
        rel_err(a, w) for a, w in zip(got, want)]
    gate(max(errs) <= GATE_SWA["float32"] and n_fwd == 1,
         f"_kernel_attention b={b4} s={s4} h={h4} d=48 padded to 64 "
         f"(float32) against plain autograd at 48: out, dq, dk, dv rel "
         + ", ".join(f"{x:.2e}" for x in errs) + f"; kernel launches "
         f"{n_fwd}")
    del q, k, v, g, ins, out, got, plain, ref, want

    # ---- the router's stable top-k against torch.topk --------------------
    moe = TC.get("qwen2-moe-a2.7b")
    probs = torch.softmax(randn((8192, moe.n_experts), torch.float32), -1)
    kk = moe.experts_per_tok
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    tv, ti = torch.topk(probs, kk, dim=-1)
    same = torch.equal(vals[:, :kk], tv) and torch.equal(idx[:, :kk], ti)
    sort_ms = timer(lambda: torch.sort(probs, dim=-1, descending=True,
                                       stable=True), 50)
    topk_ms = timer(lambda: torch.topk(probs, kk, dim=-1), 50)
    gate(same, f"router top-{kk} of 8192 x {moe.n_experts} probabilities: "
         f"the stable sort's first {kk} equal torch.topk's (untied) {same}; "
         f"sort {sort_ms:.4f} ms against topk {topk_ms:.4f} ms a layer")
    del probs, vals, idx, tv, ti

    # ---- the attention families at full width, depth cut ----------------
    total = 0
    for arch, layers, bsz, seq, n_steps in TRAIN_FAMILIES:
        full = TC.get(arch)
        cfg = dataclasses.replace(full, n_layers=layers)
        mla = cfg.attn_kind == "mla"
        L, hq = cfg.n_layers, cfg.n_heads
        dqk = cfg.qk_nope_dim + cfg.qk_rope_dim if mla else cfg.hd
        dvv = cfg.v_head_dim if mla else cfg.hd
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mgen = torch.Generator(device=dev)
        mgen.manual_seed(21)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = TS.init_state(cfg, mgen, dev)
        torch.cuda.synchronize()
        t_draw = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        p_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state.params))
        ep = TM.padded_experts(cfg.n_experts) if cfg.n_experts else 0
        idle = (L * (ep - cfg.experts_per_tok) * 3 * cfg.d_model
                * (cfg.d_expert or cfg.d_ff)) if ep else 0
        active = n_params - cfg.padded_vocab * cfg.d_model - idle
        tokens = bsz * seq
        pairs = seq * (seq + 1) // 2
        attn_flop = 3 * 2 * pairs * bsz * hq * (dqk + dvv) * L
        bound_s = (6 * active * tokens + attn_flop) / bf16_flops
        print(f"  {arch}: {L} of {full.n_layers} layers at full width "
              f"(d {cfg.d_model}, {hq} heads at width {dqk}"
              + (f", V {dvv} padded to {dqk}" if mla else "")
              + (f", {cfg.n_experts} experts padded to {ep}, top-"
                 f"{cfg.experts_per_tok}, {cfg.n_shared_experts} shared"
                 if ep else "")
              + f"), {n_params / 1e9:.3f} B parameters ({active / 1e9:.3f} "
              f"B used a token), {2 * p_bytes / 2**30:.1f} GiB of "
              f"parameters and gradients and {8 * n_params / 2**30:.1f} GiB "
              f"of moments; drawn in {t_draw:.2f} s; b={bsz} s={seq}, "
              f"{n_steps} steps on one batch, lr {TRAIN_LR}", flush=True)
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                 total_steps=n_steps)
        tcfg = TS.TrainConfig()
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=bsz),
                            dev).batch(0)
        step = TS.make_train_step(cfg, ocfg, tcfg)
        losses, walls, per_step, plain_per_step = [], [], [], []
        dropped = None
        for i in range(n_steps):
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            with recording(TM) as routes:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            per_step.append(smod.swa_attention.launches)
            plain_per_step.append(plain_cuda_calls["n"])
            losses.append(tuple(float(metrics[k]) for k in
                                ("nll", "z_loss", "aux")))
            if i == 0 and routes:
                fwd = [r for _, r in routes[:L]]
                dropped = (sum(int((~r.keep).sum()) for r in fwd),
                           sum(r.keep.numel() for r in fwd), fwd[0].cap)
            del routes
        total += sum(per_step)
        peak = torch.cuda.max_memory_allocated() - held
        steady = statistics.median(walls[1:])
        nll = [x[0] for x in losses]
        loss = [x[0] + x[1] + tcfg.aux_weight * x[2] for x in losses]
        print(f"    steps: loss " + ", ".join(f"{x:.4f}" for x in loss)
              + ", nll " + ", ".join(f"{x:.4f}" for x in nll)
              + ", aux " + ", ".join(f"{x[2]:.4f}" for x in losses)
              + f"; wall {', '.join(f'{w:.4f}' for w in walls)} s (median "
              f"after the first {steady:.4f} s, {tokens / steady:.1f} "
              f"tokens/s; bound {1e3 * bound_s:.1f} ms: 6 x {active / 1e9:.3f}"
              f" B x {tokens} tokens and {attn_flop / 1e12:.2f} TFLOP of "
              f"attention at BF16, {steady / bound_s:.1f}x); peak "
              f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held "
              f"({smi})", flush=True)
        if dropped is not None:
            print(f"    capacity path: {dropped[0]} of {dropped[1]} (token, "
                  f"slot) pairs dropped ({100 * dropped[0] / dropped[1]:.2f}"
                  f"%, {dropped[2]} slots an expert and group)", flush=True)
        gate(all(np.isfinite(losses).ravel()) and nll[-1] < nll[0]
             and all(n == 2 * L for n in per_step)
             and all(n == L for n in plain_per_step)
             and (dropped is None or dropped[0] > 0),
             f"{arch} train steps: loss, nll, aux finite, last nll "
             f"{nll[-1]:.4f} below the first {nll[0]:.4f}; swa launches per "
             f"step {per_step} ({2 * L} expected: the forward and the remat "
             f"recompute); plain swa calls per step {plain_per_step} (the "
             f"backward's recompute, one a layer)"
             + ("" if dropped is None else
                f"; {dropped[0]} pairs dropped on the capacity path"))

        g1, m1 = TS.grads_of(cfg, tcfg, state.params, batch)
        g2, m2 = TS.grads_of(cfg, tcfg, state.params, batch)
        same = tree_equal(torch, g1, g2) and all(
            torch.equal(m1[k], m2[k]) for k in m1)
        del g2, m2
        gate(same, f"{arch}: one step's gradients from one state and batch, "
             f"twice: bitwise equal {same}")
        if ep:
            moe_g = g1["units"]["b0"]["moe"]
            e = cfg.n_experts
            pad = max(float(moe_g[w][:, e:].abs().max())
                      for w in ("w_gate", "w_up", "w_out"))
            rg = moe_g["router"].float()
            gate(pad == 0.0 and bool(torch.isfinite(rg).all())
                 and float(rg.abs().max()) > 0,
                 f"{arch}: padding experts {e}..{ep - 1} w_gate, w_up, "
                 f"w_out gradients largest {pad:.1e} (exactly zero "
                 f"expected); router gradient finite, largest "
                 f"{float(rg.abs().max()):.3e}")
        del g1, m1
        torch.cuda.empty_cache()

        pieces = (((TM, "dispatch", "moe_dispatch"),
                   (TM, "expert_ffn", "moe_expert_products"),
                   (TM, "combine", "moe_combine")) if ep else ()) \
            + ((adamw, "update", "adamw_update"),)
        state, metrics = training_profile(
            torch, f"{arch} step b={bsz} s={seq}",
            lambda: step(state, batch), pieces)
        del state, metrics, batch, step
        torch.cuda.empty_cache()

    # ---- the reduced configs on the card against the CPU (float32) ------
    ocfg_r = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cgen = torch.Generator()
    for i, (arch, _) in enumerate(ZOO):
        red = TC.reduced(TC.get(arch))
        reduced_step_check(torch, gate, red, f"reduced {arch} sync step",
                           cgen, 2110 + i, dev, TS.TrainConfig(), ocfg_r,
                           patches=red.n_patches)
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


def phase22(torch, np, smi, gate, plain_cuda_calls, dev, timer,
            rates) -> int:
    """Training of the RG-LRU stack on the card (recurrentgemma-2b): the swa
    autograd Function at the model's width 256 and 10/1 heads
    (TRAIN_REC_SWA: its training shape b = 1, s = 4096, window 2048 in
    bf16, float32 at a shorter length, a small window) against plain
    autograd (bitwise gradients, one forward launch), with the forward,
    the plain-recompute backward, a flash backward's bound and SDPA with
    the band mask timed at the training shape; the doubling scan's
    gradients at TRAIN_REC_SCAN against a float64 sequential loop
    (GATE_SCAN_GRAD) and its forward and backward timed beside their byte
    bound; TRAIN_REC's steps at full width and depth (loss and nll
    finite, nll falling, two swa launches an attention layer a step and
    one plain recompute, step wall, tokens/s and peak memory above what
    the phase found held, beside the step's bound); every ``lamb`` leaf
    float32 with a finite, non-zero gradient; one step's gradients
    repeated from one state bitwise; a profiled step (busy share, the
    recompute's, the scan's and the AdamW update's shares); one sync step
    of the reduced config (float32) on the card against the CPU under
    phase 15's gates. Returns the swa launches of the trained steps."""
    import repro_torch.configs as TC
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import ssm as TSSM
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as TS

    bw, _, bf16_flops = rates
    t_phase = time.perf_counter()
    cfg = TC.get("recurrentgemma-2b")
    arch = cfg.arch_id
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_attn = kinds.count("attn")
    h, kh, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window
    print(f"phase 22: training {arch} at full width and depth "
          f"({cfg.n_layers} layers: {cfg.n_units} units of "
          f"{'/'.join(cfg.pattern)} under remat and {cfg.n_rem_layers} "
          f"remainder layers outside it) ({smi})", flush=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2200)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- the autograd Function at recurrentgemma's width -----------------
    for name, b_, s_, w_ in TRAIN_REC_SWA:
        dtype = getattr(torch, name)
        q = randn((b_, s_, h, d), dtype).requires_grad_(True)
        k, v = (randn((b_, s_, kh, d), dtype).requires_grad_(True)
                for _ in range(2))
        g = randn((b_, s_, h, d), dtype)
        tag = f"b={b_} s={s_} h/kh={h}/{kh} d={d} window={w_} {name}"
        check_swa_function(torch, gate, tag, q, k, v, g, window=w_)
        if (b_, s_, w_) == (TRAIN_REC["batch"], TRAIN_REC["seq"], w):
            time_swa_training(torch, timer, bf16_flops, tag, q, k, v, g,
                              window=w_)
        del q, k, v, g
        torch.cuda.empty_cache()

    # ---- the doubling scan's gradients ----------------------------------
    b_, s_, c_ = TRAIN_REC_SCAN
    a64 = torch.rand((b_, s_, c_), generator=gen, device=dev,
                     dtype=torch.float64) ** 0.01
    b64 = torch.randn((b_, s_, c_), generator=gen, device=dev,
                      dtype=torch.float64) * torch.sqrt(1 - a64 ** 2)
    g64 = torch.randn((b_, s_, c_), generator=gen, device=dev,
                      dtype=torch.float64)

    def loop(a, b):
        hs, out = torch.zeros_like(b[:, 0]), []
        for t in range(s_):
            hs = a[:, t] * hs + b[:, t]
            out.append(hs)
        return torch.stack(out, 1)
    ins = [t.clone().requires_grad_(True) for t in (a64, b64)]
    want = torch.autograd.grad(loop(*ins), ins, g64)
    ins = [t.float().requires_grad_(True) for t in (a64, b64)]
    g32 = g64.float()
    got = torch.autograd.grad(TSSM.linear_scan(*ins), ins, g32)
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    scan_ms = timer(lambda: torch.autograd.grad(
        TSSM.linear_scan(*ins), ins, g32), 5)
    # a, b and the upstream gradient read once, h, da and db written once
    scan_bound = 6 * ins[0].numel() * 4 / bw * 1e3
    gate(max(errs) <= GATE_SCAN_GRAD,
         f"doubling scan gradients b={b_} s={s_} width={c_} (float32) "
         f"against a float64 sequential loop on the card: da rel "
         f"{errs[0]:.2e}, db rel {errs[1]:.2e}; forward and backward "
         f"{scan_ms:.4f} ms (byte bound {scan_bound:.4f} ms) ({smi})")
    del a64, b64, g64, ins, g32, got, want
    torch.cuda.empty_cache()

    # ---- the train steps at full width and depth ------------------------
    bsz, seq, n_steps = TRAIN_REC["batch"], TRAIN_REC["seq"], \
        TRAIN_REC["steps"]
    torch.cuda.reset_peak_memory_stats()
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(22)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, mgen, dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    p_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state.params))
    active = n_params - cfg.padded_vocab * cfg.d_model
    tokens = bsz * seq
    attn_flop = 3 * 2 * swa_pairs(seq, w) * bsz * h * (2 * d) * n_attn
    bound_s = (6 * active * tokens + attn_flop) / bf16_flops
    logits_gib = tokens * cfg.padded_vocab * 4 / 2**30
    print(f"  {n_params / 1e9:.3f} B parameters ({active / 1e9:.3f} B used "
          f"a token), drawn in {t_draw:.2f} s; reckoned: parameters and "
          f"gradients {p_bytes / 2**30:.1f} GiB each, moments "
          f"{8 * n_params / 2**30:.1f} GiB, float32 logits "
          f"{logits_gib:.1f} GiB a copy; b={bsz} s={seq}, {n_steps} steps "
          f"on one batch, lr {TRAIN_LR}", flush=True)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                             total_steps=n_steps)
    tcfg = TS.TrainConfig()
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=bsz), dev).batch(0)
    step = TS.make_train_step(cfg, ocfg, tcfg)
    losses, walls, per_step, plain_per_step, retries = [], [], [], [], []

    def alloc_retries():
        # the caching allocator's frees of every cached block and retries
        # after a failed device allocation
        return torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for _ in range(n_steps):
        smod.swa_attention.launches = 0
        plain_cuda_calls["n"] = 0
        r0 = alloc_retries()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        retries.append(alloc_retries() - r0)
        per_step.append(smod.swa_attention.launches)
        plain_per_step.append(plain_cuda_calls["n"])
        losses.append((float(metrics["nll"]), float(metrics["z_loss"])))
    peak = torch.cuda.max_memory_allocated() - held
    steady = statistics.median(walls[1:])
    nll = [x[0] for x in losses]
    print(f"    steps: loss " + ", ".join(f"{x + z:.4f}" for x, z in losses)
          + ", nll " + ", ".join(f"{x:.4f}" for x in nll)
          + f"; wall {', '.join(f'{t:.4f}' for t in walls)} s (median "
          f"after the first {steady:.4f} s, {tokens / steady:.1f} tokens/s; "
          f"bound {1e3 * bound_s:.1f} ms: 6 x {active / 1e9:.3f} B x "
          f"{tokens} tokens and {attn_flop / 1e12:.2f} TFLOP of windowed "
          f"attention at BF16, {steady / bound_s:.1f}x); peak "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; "
          f"allocator retries per step {retries} ({smi})", flush=True)
    gate(all(np.isfinite(losses).ravel()) and nll[-1] < nll[0]
         and all(n == 2 * n_attn for n in per_step)
         and all(n == n_attn for n in plain_per_step),
         f"{arch} train steps: loss and nll finite, last nll {nll[-1]:.4f} "
         f"below the first {nll[0]:.4f}; swa launches per step {per_step} "
         f"({2 * n_attn} expected: the forward and the remat recompute of "
         f"{n_attn} attention layers); plain swa calls per step "
         f"{plain_per_step} (the backward's recompute, one a layer)")

    g1, m1 = TS.grads_of(cfg, tcfg, state.params, batch)
    g2, m2 = TS.grads_of(cfg, tcfg, state.params, batch)
    same = tree_equal(torch, g1, g2) and all(
        torch.equal(m1[k], m2[k]) for k in m1)
    del g2, m2
    gate(same, f"{arch}: one step's gradients from one state and batch, "
         f"twice: bitwise equal {same}")
    # a unit slot's leaf stacks its units' rows: each row must move
    grads = dict(tree_items(g1))
    lamb = [(key, p, grads[key]) for key, p in tree_items(state.params)
            if key.endswith("/lamb")]
    ok = [p.dtype == torch.float32 and gl.dtype == torch.float32
          and bool(torch.isfinite(gl).all())
          and bool(gl.reshape(-1, gl.shape[-1]).any(-1).all())
          for _, p, gl in lamb]
    gate(len(lamb) == cfg.pattern.count("rec") + cfg.n_rem_layers
         and all(ok),
         f"{arch}: {len(lamb)} lamb leaves ({', '.join(k for k, _, _ in lamb)})"
         f" float32, each layer's gradient finite and non-zero {all(ok)}; "
         f"largest " + ", ".join(f"{float(gl.abs().max()):.3e}"
                                for _, _, gl in lamb))
    del g1, m1, grads, lamb
    torch.cuda.empty_cache()

    state, metrics = training_profile(
        torch, f"{arch} step b={bsz} s={seq}", lambda: step(state, batch),
        ((TSSM, "linear_scan", "rglru_scan"),
         (adamw, "update", "adamw_update")))
    del state, metrics, batch, step
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU (float32) -------
    reduced_step_check(torch, gate, TC.reduced(cfg),
                       f"reduced {arch} sync step", torch.Generator(), 2210,
                       dev, tcfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10))
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sum(per_step)


def mlstm_parallel64(torch, q, k, v, li, lf):
    """The mLSTM over a whole sequence in its parallel form, in float64:
    h_j = sum_k s_jk v_k / max(|sum_k s_jk|, exp(-m_j)) with s_jk =
    (q_j . k_k / sqrt(d)) exp(D_jk - m_j), D_jk = b_j - b_k + li_k for k
    <= j (b the inclusive cumulative sum of lf) and m_j = max_k D_jk. h
    does not depend on the stabiliser m, so this is the chunk scan's h
    with another one, and none of its chunking."""
    q, k, v, li, lf = (t.double() for t in (q, k, v, li, lf))
    s = q.shape[-2]
    b = torch.cumsum(lf, dim=-1)
    D = b[..., :, None] - b[..., None, :] + li[..., None, :]
    future = ~torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    D = D.masked_fill(future, float("-inf"))
    m = D.amax(dim=-1)
    S = (q @ k.transpose(-1, -2)) / q.shape[-1] ** 0.5 \
        * torch.exp(D - m[..., None])
    den = torch.maximum(S.sum(dim=-1).abs(), torch.exp(-m))
    return (S @ v) / den[..., None]


def slstm_loop64(torch, zx, r_gates):
    """The sLSTM cell run position by position in float64 from the zero
    state (m at -1e30) on the input gates zx (B, S, 4d) -> h (B, S, d)."""
    import torch.nn.functional as Fn

    zx, r = zx.double(), r_gates.double()
    b, d = zx.shape[0], r.shape[0]
    c = n = h = torch.zeros((b, d), dtype=torch.float64, device=zx.device)
    m = torch.full((b, d), -1e30, dtype=torch.float64, device=zx.device)
    hs = []
    for t in range(zx.shape[1]):
        zi, zf, zz, zo = (zx[:, t] + h @ r).chunk(4, dim=-1)
        lf = Fn.logsigmoid(zf)
        m_new = torch.maximum(lf + m, zi)
        ip, fp = torch.exp(zi - m_new), torch.exp(lf + m - m_new)
        c, n, m = fp * c + ip * torch.tanh(zz), fp * n + ip, m_new
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    return torch.stack(hs, dim=1)


def phase23(torch, np, smi, gate, plain_cuda_calls, dev, timer,
            rates) -> None:
    """Training of the xLSTM stack on the card (xlstm-1.3b): the mLSTM
    chunk scan's gradients at the model's heads (TRAIN_XL_SCAN, four
    chunks, float32) against the parallel form in float64
    (GATE_XL_SCAN_GRAD), its forward and backward timed beside their FP32
    bound; the sLSTM position loop's gradients at the model's width
    (TRAIN_XL_SLSTM, float32) against the cell in float64
    (GATE_XL_SLSTM_GRAD), its forward and backward timed in bf16 beside
    its byte bounds; TRAIN_XL's steps at full width, three of the six
    units (loss and nll finite, nll falling, no swa launch and no plain
    attention call, step wall, tokens/s, peak memory above what the phase
    found held and allocator retries a step, beside the step's bound);
    every ``w_if``,
    ``skip`` and ``out_norm`` leaf float32 with a finite, non-zero
    gradient in every layer; at one unit's depth (TRAIN_XL_UNIT) one
    step's gradients repeated bitwise from one state, the sLSTM layer's
    ``r_gates`` gradient in bf16 against a float32 run of the layer on its
    real input (reported), and a profiled step at XL_PROFILED tokens (busy
    share, the chunk scan's, the sLSTM loop's and the AdamW update's
    shares); one sync step of the reduced config (float32) on the card
    against the CPU, its gradients and flips held to GATE_XL_TRAIN_GRAD
    and GATE_XL_TRAIN_FLIPS."""
    import dataclasses

    import torch.nn.functional as Fn

    import repro_torch.configs as TC
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import xlstm as TX
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as TS

    bw, flops, bf16_flops = rates
    t_phase = time.perf_counter()
    cfg = TC.get("xlstm-1.3b")
    arch = cfg.arch_id
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_m, n_s = kinds.count("m"), kinds.count("s")
    du, nh, hd = TX._mlstm_dims(cfg)
    L, d = TX.MLSTM_CHUNK, cfg.d_model
    print(f"phase 23: training {arch} at full width ({cfg.n_layers} layers: "
          f"{cfg.n_units} units of {'/'.join(cfg.pattern)} under remat; "
          f"{n_m} mLSTM of width {du} in {nh} heads of {hd}, chunk {L}; "
          f"{n_s} sLSTM of width {d}; the steps at {TRAIN_XL['layers']} "
          f"layers) ({smi})", flush=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2300)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def scan_flop(b, h, s_len, w):
        """The chunk scan's products: q k^T and S v within each chunk, q C
        and k^T v across."""
        return (s_len // L) * (4 * b * h * L * L * w + 4 * b * h * L * w * w)

    # ---- the chunk scan's gradients ---------------------------------------
    b_, h_, s_, w_ = TRAIN_XL_SCAN
    ins = [randn((b_, h_, s_, w_)) for _ in range(3)]
    ins += [randn((b_, h_, s_)), Fn.logsigmoid(randn((b_, h_, s_)) + 5.0)]
    g = randn((b_, h_, s_, w_))
    live = [t.clone().requires_grad_(True) for t in ins]
    got = torch.autograd.grad(TX._mlstm_chunk_scan(*live)[0], live, g)
    live64 = [t.double().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(mlstm_parallel64(torch, *live64), live64,
                               g.double())
    errs = [rel_err(x, y) for x, y in zip(got, want)]

    def scan_grads():
        torch.autograd.grad(TX._mlstm_chunk_scan(*live)[0], live, g)
    scan_ms = timer(scan_grads, 5)
    # the forward's products, then twice as many in the backward
    scan_bound = 3 * scan_flop(b_, h_, s_, w_) / flops * 1e3
    gate(max(errs) <= GATE_XL_SCAN_GRAD,
         f"{arch} mLSTM chunk scan gradients b={b_} h={h_} s={s_} d={w_} "
         f"({s_ // L} chunks, float32, TF32 off) against the parallel form "
         f"in float64 on the card: rel dq {errs[0]:.2e}, dk {errs[1]:.2e}, "
         f"dv {errs[2]:.2e}, dli {errs[3]:.2e}, dlf {errs[4]:.2e} (gate "
         f"{GATE_XL_SCAN_GRAD:.0e}); forward and backward {scan_ms:.4f} ms "
         f"(bound {scan_bound:.4f} ms, operations at FP32) ({smi})")
    del ins, g, live, got, live64, want
    torch.cuda.empty_cache()

    # ---- the sLSTM loop's gradients --------------------------------------
    b_, s_, w_ = TRAIN_XL_SLSTM
    zx = randn((b_, s_, 4 * w_))
    r = randn((w_, 4 * w_)) * (0.5 / w_ ** 0.5)
    g = randn((b_, s_, w_))
    live = [t.clone().requires_grad_(True) for t in (zx, r)]
    got = torch.autograd.grad(
        TX._slstm_scan({"r_gates": live[1]}, live[0])[0], live, g)
    live64 = [t.double().requires_grad_(True) for t in (zx, r)]
    want = torch.autograd.grad(slstm_loop64(torch, *live64), live64,
                               g.double())
    errs = [rel_err(x, y) for x, y in zip(got, want)]
    live = [t.to(torch.bfloat16).requires_grad_(True) for t in (zx, r)]
    g16 = g.to(torch.bfloat16)

    def loop_grads():
        torch.autograd.grad(
            TX._slstm_scan({"r_gates": live[1]}, live[0])[0], live, g16)
    loop_ms = timer(loop_grads, 2)
    r_bytes = r.numel() * 2
    # r_gates read once and its gradient written once (held in the 50 MB
    # L2 across positions), or read from HBM by every position's forward
    # and backward
    once = 2 * r_bytes / bw * 1e3
    per_pos = 2 * s_ * r_bytes / bw * 1e3
    gate(max(errs) <= GATE_XL_SLSTM_GRAD,
         f"{arch} sLSTM loop gradients b={b_} s={s_} d={w_} (float32) "
         f"against the cell in float64 on the card: rel dzx {errs[0]:.2e}, "
         f"dr_gates {errs[1]:.2e} (gate {GATE_XL_SLSTM_GRAD:.0e}); bf16 "
         f"forward and backward {loop_ms:.4f} ms = "
         f"{loop_ms / s_:.4f} ms a position; bounds (bytes): r_gates "
         f"({r_bytes / 1e6:.1f} MB bf16) read once and its gradient written "
         f"once, held in the L2 {once:.4f} ms; read from HBM by each "
         f"position's forward and backward {per_pos:.4f} ms "
         f"({per_pos / s_:.4f} ms a position) ({smi})")
    del zx, r, g, g16, live, got, live64, want
    torch.cuda.empty_cache()

    # ---- the train steps at full width, TRAIN_XL's depth ---------------
    bsz, seq, n_steps = TRAIN_XL["batch"], TRAIN_XL["seq"], TRAIN_XL["steps"]
    cut = dataclasses.replace(cfg, n_layers=TRAIN_XL["layers"])
    n_m = cut.n_units * cut.pattern.count("m")
    torch.cuda.reset_peak_memory_stats()
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TS.init_state(cut, mgen, dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    p_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state.params))
    active = n_params - cfg.padded_vocab * cfg.d_model
    tokens = bsz * seq
    # the products at BF16 and the float32 chunk scans (forward, remat
    # recompute and a backward of twice the forward's) at FP32
    chunk_flop = 4 * n_m * scan_flop(bsz, nh, seq, hd)
    bound_s = 6 * active * tokens / bf16_flops + chunk_flop / flops
    logits_gib = tokens * cfg.padded_vocab * 4 / 2**30
    print(f"  {cut.n_layers} layers ({cut.n_units} units): "
          f"{n_params / 1e9:.3f} B parameters ({active / 1e9:.3f} B used a "
          f"token), drawn in "
          f"{t_draw:.2f} s; reckoned: parameters and gradients "
          f"{p_bytes / 2**30:.1f} GiB each, moments "
          f"{8 * n_params / 2**30:.1f} GiB, float32 logits "
          f"{logits_gib:.1f} GiB a copy; b={bsz} s={seq} ({seq // L} "
          f"chunks), {n_steps} steps on one batch, lr {TRAIN_LR}",
          flush=True)
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                             total_steps=n_steps)
    tcfg = TS.TrainConfig()
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=bsz), dev).batch(0)
    step = TS.make_train_step(cut, ocfg, tcfg)
    kept = ("/w_if", "/skip", "/out_norm")
    update, seen = adamw.update, {}

    def recorded(ocfg_, grads, opt, params):
        # the step's gradients of the float32 leaves, as the update gets
        # them: type, finite, and non-zero in every layer of a stacked leaf
        for (key, p), (_, gl) in zip(tree_items(params), tree_items(grads)):
            if key.endswith(kept):
                rows = gl.reshape(gl.shape[0], -1) if key.startswith(
                    "/units") else gl.reshape(1, -1)
                seen[key] = (p.dtype, gl.dtype,
                             bool(torch.isfinite(gl).all()),
                             bool(rows.any(-1).all()),
                             float(gl.abs().max()))
        return update(ocfg_, grads, opt, params)
    losses, walls, swa, plain, retries = [], [], [], [], []

    def alloc_retries():
        return torch.cuda.memory_stats().get("num_alloc_retries", 0)
    adamw.update = recorded
    try:
        for _ in range(n_steps):
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            r0 = alloc_retries()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            retries.append(alloc_retries() - r0)
            swa.append(smod.swa_attention.launches)
            plain.append(plain_cuda_calls["n"])
            losses.append((float(metrics["nll"]), float(metrics["z_loss"])))
    finally:
        adamw.update = update
    peak = torch.cuda.max_memory_allocated() - held
    nll = [x[0] for x in losses]
    print(f"    steps: loss " + ", ".join(f"{x + z:.4f}" for x, z in losses)
          + ", nll " + ", ".join(f"{x:.4f}" for x in nll)
          + f"; wall {', '.join(f'{t:.4f}' for t in walls)} s (last "
          f"{tokens / walls[-1]:.1f} tokens/s; bound {1e3 * bound_s:.1f} "
          f"ms: 6 x {active / 1e9:.3f} B x {tokens} tokens at BF16 and "
          f"{chunk_flop / 1e12:.2f} TFLOP of chunk scans at FP32, "
          f"{walls[-1] / bound_s:.1f}x); peak {peak / 2**30:.2f} GiB above "
          f"the {held / 2**30:.2f} GiB held, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; "
          f"allocator retries per step {retries} ({smi})", flush=True)
    gate(all(np.isfinite(losses).ravel()) and nll[-1] < nll[0]
         and not any(swa) and not any(plain),
         f"{arch} at {cut.n_layers} layers, train steps: loss and nll "
         f"finite, last nll {nll[-1]:.4f} below the first {nll[0]:.4f}; "
         f"swa launches per step {swa}, plain attention calls on CUDA "
         f"tensors {plain} (no attention layer)")
    ok = [pt == torch.float32 and gt == torch.float32 and fin and nonzero
          for pt, gt, fin, nonzero, _ in seen.values()]
    # three such leaves an mLSTM slot, one an sLSTM slot (no remainder)
    gate(len(seen) == sum({"m": 3, "s": 1}[k] for k in cfg.pattern)
         and all(ok),
         f"{arch}: {len(seen)} w_if/skip/out_norm leaves float32, each "
         f"layer's gradient in the last step finite and non-zero "
         f"{all(ok)}; largest " + ", ".join(
             f"{key.split('/', 3)[-1]} {v[-1]:.2e}"
             for key, v in list(seen.items())[:4]) + ", ...")
    del state, metrics, batch, step, seen
    torch.cuda.empty_cache()

    # ---- one unit: a bitwise repeat, bf16 r_gates, a profiled step -------
    c8 = dataclasses.replace(cfg, n_layers=TRAIN_XL_UNIT)
    mgen.manual_seed(2308)
    state = TS.init_state(c8, mgen, dev)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=bsz), dev).batch(0)
    g1, m1 = TS.grads_of(c8, tcfg, state.params, batch)
    g2, m2 = TS.grads_of(c8, tcfg, state.params, batch)
    same = tree_equal(torch, g1, g2) and all(
        torch.equal(m1[k], m2[k]) for k in m1)
    del g1, g2, m1, m2
    gate(same, f"{arch} at {TRAIN_XL_UNIT} layers: one step's gradients "
         f"from one state and batch, twice: bitwise equal {same}")

    # the sLSTM layer on its real input in this forward: the r_gates
    # gradient in bf16 (autograd sums every position's share in the
    # leaf's type, as the reference's scan does) against float32
    captured, apply = [], TX.slstm_apply

    def capture(cfg_, p, x, **kw):
        if not captured:
            captured.append((p, x.detach().clone()))
        return apply(cfg_, p, x, **kw)
    TX.slstm_apply = capture
    try:
        with torch.no_grad():
            TS.make_loss_fn(c8, tcfg)(state.params, batch)
    finally:
        TX.slstm_apply = apply
    p16, x16 = captured[0]
    gy = randn(x16.shape, torch.bfloat16)
    r_grads = []
    for dtype in (torch.bfloat16, torch.float32):
        p = {k: t.to(dtype) for k, t in p16.items()}
        p["r_gates"] = p["r_gates"].clone().requires_grad_(True)
        out = TX.slstm_apply(c8, p, x16.to(dtype))
        r_grads.append(torch.autograd.grad(out, p["r_gates"],
                                           gy.to(dtype))[0])
    print(f"  sLSTM r_gates gradient over {seq} positions in bf16 (type "
          f"{r_grads[0].dtype}) against a float32 run of the layer on its "
          f"input in this step: rel {rel_err(*r_grads):.3e} (reported, not "
          f"gated) ({smi})", flush=True)
    del captured, p16, x16, gy, r_grads, p, out
    # the profiled step at XL_PROFILED tokens: the chunk scans' work and
    # the sLSTM steps both grow linearly in s, and a step of 4096 tokens
    # traced 2.08 M events that took 74 s to read back
    batch = {k: v[:, :XL_PROFILED] for k, v in batch.items()}
    step = TS.make_train_step(c8, ocfg, tcfg)
    state, metrics = training_profile(
        torch, f"{arch} at {TRAIN_XL_UNIT} layers, step b={bsz} "
        f"s={XL_PROFILED}", lambda: step(state, batch),
        ((TX, "_mlstm_chunk_scan", "mlstm_chunk_scan"),
         (TX, "_slstm_scan", "slstm_loop"),
         (adamw, "update", "adamw_update")))
    del state, metrics, batch, step
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU (float32) -------
    reduced_step_check(torch, gate, TC.reduced(cfg),
                       f"reduced {arch} sync step", torch.Generator(), 2310,
                       dev, tcfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10),
                       grad_gate=GATE_XL_TRAIN_GRAD,
                       flips_gate=GATE_XL_TRAIN_FLIPS)
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s", flush=True)


def full_attention64(torch, q, k, v):
    """Unmasked attention over materialised scores in float64 throughout:
    ``_full_attention``'s math without its float32 softmax and casts."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[3] ** 0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


def phase24(torch, np, smi, gate, plain_cuda_calls, dev, timer,
            rates) -> int:
    """Training of whisper-tiny on the card at full width and depth: the swa
    autograd Function at the decoder's width (TRAIN_WH_SWA: 6/6 heads of
    64, its training shape b = 8 x 4096 in bf16 and float32 at a shorter
    length) against plain autograd (bitwise gradients, one forward
    launch), with the forward, the plain-recompute backward, a flash
    backward's bound and SDPA timed at the training shape; the non-causal
    attention's gradients (``_full_attention``, TRAIN_WH_FULL: the
    encoder's and the cross-attention's shapes, float32) against float64
    on the card (GATE_FULL_GRAD), the cross shape's forward and backward
    timed in bf16 beside its bound and SDPA; TRAIN_WH's steps (loss and
    nll finite, nll falling, two swa launches a decoder layer a step and
    one plain recompute, the non-causal calls a step: the encoder's and
    the cross-attention's forward and the cross-attention's remat
    recompute; step wall, decoder tokens/s, peak memory above what the
    phase found held and allocator retries, beside the step's bound);
    every gradient finite and every row of both position tables with a
    non-zero gradient; one step's gradients repeated from one state
    bitwise; a profiled step (busy share, the recompute's, the encoder's,
    the non-causal attention's and the AdamW update's shares); one sync
    step of the reduced config with frames (float32) on the card against
    the CPU under phase 15's gates. Returns the swa launches of the
    trained steps."""
    import torch.nn.functional as Fn

    import repro_torch.configs as TC
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.models import attention as TA
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as TS

    bw, _, bf16_flops = rates
    t_phase = time.perf_counter()
    cfg = TC.get("whisper-tiny")
    arch = cfg.arch_id
    L, Le = cfg.n_layers, cfg.n_enc_layers
    h, kh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    bsz, seq, n_frames, n_steps = (TRAIN_WH[k] for k in
                                   ("batch", "seq", "frames", "steps"))
    print(f"phase 24: training {arch} at full width and depth ({Le} encoder "
          f"layers outside remat, {L} decoder units of "
          f"{'/'.join(cfg.pattern)} under remat; d={d}, {h}/{kh} heads of "
          f"{hd}, vocab {cfg.vocab_size} padded to {cfg.padded_vocab}) "
          f"({smi})", flush=True)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2400)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- the autograd Function at whisper's width -----------------------
    for name, b_, s_ in TRAIN_WH_SWA:
        dtype = getattr(torch, name)
        q = randn((b_, s_, h, hd), dtype).requires_grad_(True)
        k, v = (randn((b_, s_, kh, hd), dtype).requires_grad_(True)
                for _ in range(2))
        g = randn((b_, s_, h, hd), dtype)
        tag = f"b={b_} s={s_} h/kh={h}/{kh} d={hd} causal {name}"
        check_swa_function(torch, gate, tag, q, k, v, g)
        if (b_, s_, dtype) == (bsz, seq, torch.bfloat16):
            time_swa_training(torch, timer, bf16_flops, tag, q, k, v, g)
        del q, k, v, g
        torch.cuda.empty_cache()

    # ---- the non-causal attention's backward against float64 ------------
    for b_, sq, sk in TRAIN_WH_FULL:
        q = randn((b_, sq, h, hd))
        k, v = (randn((b_, sk, h, hd)) for _ in range(2))
        g = randn((b_, sq, h, hd))
        live = [t.clone().requires_grad_(True) for t in (q, k, v)]
        got = torch.autograd.grad(TA._full_attention(*live), live, g)
        live64 = [t.double().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(full_attention64(torch, *live64), live64,
                                   g.double())
        errs = [rel_err(x, y) for x, y in zip(got, want)]
        del live, got, live64, want
        what = "the encoder's" if sq == sk else "the cross-attention's"
        line = (f"{arch} non-causal attention gradients at {what} shape "
                f"b={b_} queries={sq} keys={sk} h={h} d={hd} (float32, TF32 "
                f"off) against float64 on the card: rel dq {errs[0]:.2e}, "
                f"dk {errs[1]:.2e}, dv {errs[2]:.2e} (gate "
                f"{GATE_FULL_GRAD:.0e})")
        if (sq, sk) == (seq, n_frames):
            q, k, v = (t.to(torch.bfloat16).requires_grad_(True)
                       for t in (q, k, v))
            g = g.to(torch.bfloat16)
            qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))
            gt = g.transpose(1, 2)

            def plain():
                torch.autograd.grad(TA._full_attention(q, k, v), (q, k, v),
                                    g)

            def library():
                torch.autograd.grad(Fn.scaled_dot_product_attention(
                    qt, kt, vt), (qt, kt, vt), gt)
            full_ms = timer(plain, 5)
            lib_ms = timer(library, 10)
            elems = b_ * h * sq * sk
            # the forward's two products, the backward's four
            flop = 12 * elems * hd
            # the float32 scores written and read once in the forward, the
            # probabilities read and the scores' gradient written once in
            # the backward
            by = 4 * 4 * elems
            t_fl, t_by = flop / bf16_flops * 1e3, by / bw * 1e3
            line += (f"; bf16 forward and backward {full_ms:.4f} ms (bound "
                     f"{max(t_fl, t_by):.4f} ms by "
                     f"{'bytes' if t_by >= t_fl else 'operations'}: "
                     f"{flop / 1e9:.1f} GFLOP at BF16 {t_fl:.4f} ms, the "
                     f"float32 scores {by / 1e9:.2f} GB moved "
                     f"{t_by:.4f} ms); sdpa forward and backward "
                     f"{lib_ms:.4f} ms ({smi})")
            del qt, kt, vt, gt
        gate(max(errs) <= GATE_FULL_GRAD, line)
        del q, k, v, g
        torch.cuda.empty_cache()

    # ---- the train steps at full width and depth ------------------------
    torch.cuda.reset_peak_memory_stats()
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(24)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, mgen, dev)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    p = state.params

    def count(tree):
        return sum(t.numel() for t in tree_leaves(tree))
    n_params = count(p)
    # the cross-attention's K and V project the frames, not the tokens
    cross_kv = sum(p["units"][f"b{s}"]["cross"][w].numel()
                   for s in range(len(cfg.pattern)) for w in ("wk", "wv"))
    per_token = count(p["units"]) - cross_kv + p["head"].numel()
    per_frame = count(p["encoder"]["layers"]) + cross_kv
    tokens, frame_rows = bsz * seq, bsz * n_frames
    prod_flop = 6 * per_token * tokens + 6 * per_frame * frame_rows
    # forward and backward (three times the forward's two products)
    attn_flop = 3 * 4 * hd * bsz * h * (
        L * swa_pairs(seq, 0) + L * seq * n_frames + Le * n_frames ** 2)
    bound_s = (prod_flop + attn_flop) / bf16_flops
    print(f"  {n_params / 1e6:.3f} M parameters (embedding "
          f"{p['embed'].numel() / 1e6:.3f} M, head "
          f"{p['head'].numel() / 1e6:.3f} M; {per_token / 1e6:.3f} M used a "
          f"token, {per_frame / 1e6:.3f} M a frame), drawn in "
          f"{t_draw:.2f} s; b={bsz} s={seq} over {n_frames} frames, "
          f"{n_steps} steps on one batch, lr {TRAIN_LR}; float32 logits "
          f"{tokens * cfg.padded_vocab * 4 / 1e9:.1f} GB a copy", flush=True)
    del p
    ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                             total_steps=n_steps)
    tcfg = TS.TrainConfig()
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=bsz), dev).batch(0)
    batch["enc_frames"] = randn((bsz, n_frames, d), cfg.torch_dtype)
    step = TS.make_train_step(cfg, ocfg, tcfg)
    losses, walls, swa, plain, full, retries = [], [], [], [], [], []

    def alloc_retries():
        return torch.cuda.memory_stats().get("num_alloc_retries", 0)
    with counting_calls(TA, "_full_attention") as calls:
        for _ in range(n_steps):
            smod.swa_attention.launches = 0
            plain_cuda_calls["n"] = 0
            calls["n"] = 0
            r0 = alloc_retries()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            retries.append(alloc_retries() - r0)
            swa.append(smod.swa_attention.launches)
            plain.append(plain_cuda_calls["n"])
            full.append(calls["n"])
            losses.append((float(metrics["nll"]), float(metrics["z_loss"])))
    peak = torch.cuda.max_memory_allocated() - held
    steady = statistics.median(walls[1:])
    nll = [x[0] for x in losses]
    print(f"    steps: loss " + ", ".join(f"{x + z:.4f}" for x, z in losses)
          + ", nll " + ", ".join(f"{x:.4f}" for x in nll)
          + f"; wall {', '.join(f'{t:.4f}' for t in walls)} s (median "
          f"after the first {steady:.4f} s, {tokens / steady:.1f} decoder "
          f"tokens/s; bound {1e3 * bound_s:.2f} ms: 6 x "
          f"{per_token / 1e6:.3f} M x {tokens} tokens and 6 x "
          f"{per_frame / 1e6:.3f} M x {frame_rows} frames, "
          f"{prod_flop / 1e12:.2f} TFLOP, and {attn_flop / 1e12:.2f} TFLOP "
          f"of causal, cross and encoder attention at BF16, "
          f"{steady / bound_s:.1f}x); peak {peak / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; "
          f"allocator retries per step {retries} ({smi})", flush=True)
    gate(all(np.isfinite(losses).ravel()) and nll[-1] < nll[0]
         and all(n == 2 * L for n in swa) and all(n == L for n in plain)
         and all(n == Le + 2 * L for n in full),
         f"{arch} train steps: loss and nll finite, last nll {nll[-1]:.4f} "
         f"below the first {nll[0]:.4f}; swa launches per step {swa} "
         f"({2 * L} expected: the forward and the remat recompute of {L} "
         f"decoder layers); plain swa calls per step {plain} (the "
         f"backward's recompute, one a layer); non-causal plain attention "
         f"calls per step {full} ({Le} encoder layers once, {L} "
         f"cross-attention layers and their remat recompute)")

    g1, m1 = TS.grads_of(cfg, tcfg, state.params, batch)
    g2, m2 = TS.grads_of(cfg, tcfg, state.params, batch)
    same = tree_equal(torch, g1, g2) and all(
        torch.equal(m1[k], m2[k]) for k in m1)
    del g2, m2
    gate(same, f"{arch}: one step's gradients from one state and batch, "
         f"twice: bitwise equal {same}")
    leaves = dict(tree_items(g1))
    finite = all(bool(torch.isfinite(t).all()) for t in leaves.values())
    rows = [int(t.ne(0).any(-1).sum()) for t in
            (g1["pos_table"], g1["encoder"]["pos_table"])]
    want_rows = [min(seq, TT.POS_ROWS), n_frames]
    gate(finite and rows == want_rows,
         f"{arch}: {len(leaves)} gradient leaves, all finite {finite}; rows "
         f"with a non-zero gradient: the decoder's position table "
         f"{rows[0]} of {g1['pos_table'].shape[0]}, the encoder's "
         f"{rows[1]} of {g1['encoder']['pos_table'].shape[0]} (expected "
         f"{want_rows[0]} and {want_rows[1]})")
    del g1, m1, leaves
    torch.cuda.empty_cache()

    def at_position_table(args, wrap):
        # the encoder's backward leaves through its position table after
        # its first layer; the frames take no gradient
        cfg_, params, frames = args
        enc = params["encoder"]
        if not enc["pos_table"].requires_grad:
            return args
        enc = dict(enc, pos_table=wrap(enc["pos_table"]))
        return [cfg_, dict(params, encoder=enc), frames]
    state, metrics = training_profile(
        torch, f"{arch} step b={bsz} s={seq} frames={n_frames}",
        lambda: step(state, batch),
        ((TT, "encode", "encoder", at_position_table),
         (TA, "_full_attention", "noncausal_attention"),
         (adamw, "update", "adamw_update")))
    print("    the ranges nest: noncausal_attention holds the encoder's "
          "self-attention (inside encoder) and the cross-attention's (inside "
          "the decoder units, forward, remat recompute and backward); "
          "swa_backward_recompute holds the causal self-attention's "
          "backward only; adamw_update lies outside the others", flush=True)
    del state, metrics, batch, step
    torch.cuda.empty_cache()

    # ---- the reduced config on the card against the CPU (float32) -------
    red = TC.reduced(cfg)
    reduced_step_check(torch, gate, red, f"reduced {arch} sync step with "
                       f"{red.n_frames} frames", torch.Generator(), 2410,
                       dev, tcfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10),
                       frames=red.n_frames)
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return sum(swa)


def _tree_to(tree, device):
    return {k: (_tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


# ------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np
    import repro_torch.api as A
    from repro_torch.core import (euclidean_graph, grid_graph,
                                  scale_free_graph)
    from repro_torch.core.batched import _bucket_design
    from repro_torch.kernels.build import LIBRARIES
    from repro_torch.kernels.cl import kernel as kmod
    from repro_torch.kernels.cl import newton as nmod
    from repro_torch.kernels.cl import ops as omod
    from repro_torch.kernels.cl.family import family_kernel_inputs

    dev = torch.device("cuda")
    timer = Timer(torch)
    failures = []

    def gate(ok: bool, what: str):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    # ---- phase 1: build -------------------------------------------------
    build_s = LIBRARIES.build_all()
    print(f"phase 1: built {LIBRARIES.builds} kernel libraries in "
          f"{build_s:.2f} s", flush=True)
    for lib, text in LIBRARIES.ptxas.items():
        for line in text.splitlines():
            if "Used" in line:
                print(f"  ptxas {lib}: {line.split(':', 1)[1].strip()}")

    # ---- phase 2: card identity -----------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind_name = torch.cuda.get_device_name(0)
    bw, flops, bf16_flops = card_rates(kind_name)
    print(f"phase 2: {kind_name}; bound rates {bw:.3g} B/s, "
          f"{flops:.3g} FP32 FLOP/s, {bf16_flops:.3g} BF16 FLOP/s "
          f"(data sheet)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(20120626)
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(4)

    def truth(graph, family, scale_edge, scale_node, q=3):
        C = 1 if family == "ising" else q - 1
        node = scale_node * torch.randn(graph.p * C, generator=cpu_gen,
                                        dtype=torch.float64)
        edge = scale_edge * torch.randn(graph.m * C, generator=cpu_gen,
                                        dtype=torch.float64)
        return torch.cat([node, edge])

    # data of phases 4 and 5, drawn first so phase 3 can use their shapes
    t0 = time.perf_counter()
    g_eu = euclidean_graph(100, radius=0.15, seed=0)
    g_sf = scale_free_graph(100, m=1, seed=0)
    g_field = grid_graph(64, 64)
    paper = []
    for name, g, fam, combs in (
            ("euclidean_ising", g_eu, "ising", PAPER_COMBINERS),
            ("scalefree_ising", g_sf, "ising", PAPER_COMBINERS),
            ("euclidean_potts3", g_eu, "potts", ("diagonal",))):
        th = (truth(g, fam, 0.5, 0.5) if fam == "ising"
              else truth(g, fam, 0.4, 0.3))
        X = gibbs_sample(torch, g, fam, th, 4000, 150, gen, dev)
        paper.append((name, g, fam, combs, th, X))
    th_field = truth(g_field, "ising", 0.5, 0.5)
    X_field = gibbs_sample(torch, g_field, "ising", th_field, 2 * 16384, 100,
                           gen, dev)
    torch.cuda.synchronize()
    print(f"sampling: {time.perf_counter() - t0:.2f} s (chromatic Gibbs on "
          f"the card)", flush=True)

    # ---- phase 3: kernels against their plain versions ------------------
    print("phase 3: kernels against their plain versions on the card")
    errs = {"newton": 0.0, "score_c1": 0.0, "score_cn": 0.0}

    covered = set()     # (kind, design shape, weighted) held against plain

    def check_newton(tag, kind, Zb, base, xi, W, sw):
        covered.add((kind, tuple(Zb.shape), sw is not None))
        g1, K1 = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
        g2, K2 = nmod.bucket_newton_stats(kind, Zb, base, xi, W, sw)
        g0, K0 = nmod.bucket_newton_stats_ref(kind, Zb, base, xi, W, sw)
        torch.cuda.synchronize()
        eg, eK = rel_err(g1, g0), rel_err(K1, K0)
        same = torch.equal(g1, g2) and torch.equal(K1, K2)
        errs["newton"] = max(errs["newton"], abs_err(g1, g0),
                             abs_err(K1, K0))
        gate(eg <= GATE_STATS and eK <= GATE_STATS and same,
             f"newton {tag}: rel g {eg:.2e} K {eK:.2e}; a second call "
             f"bitwise equal {same}")

    def check_score(tag, kind, F, th, mask, bias):
        e1, r1, S1 = kmod.cl_score_channels(F, th, mask, bias, kind=kind)
        e0, r0, S0 = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
        torch.cuda.synchronize()
        ee, er, eS = rel_err(e1, e0), rel_err(r1, r0), rel_err(S1, S0)
        key = "score_c1" if F.shape[0] == 1 else "score_cn"
        errs[key] = max(errs[key], abs_err(e1, e0), abs_err(r1, r0),
                        abs_err(S1, S0))
        gate(ee <= GATE_ELEM and er <= GATE_ELEM and eS <= GATE_STATS,
             f"score {tag}: rel eta {ee:.2e} r {er:.2e} S {eS:.2e}")

    # synthetic: all kinds, weighted and not, ragged n and p
    for kind, C in (("ising", 1), ("gaussian", 1), ("potts", 2)):
        for d in (2, 5, 17, 65):
            for weighted in (False, True):
                k, n = 7, 1001
                if kind == "potts":
                    xi = torch.randint(0, 3, (k, n), generator=gen,
                                       device=dev).float()
                    Zb = (torch.randint(0, 3, (k, C, d, n), generator=gen,
                                        device=dev) == 1).float()
                elif kind == "ising":
                    xi = torch.where(torch.rand((k, n), generator=gen,
                                                device=dev) < .5, 1., -1.)
                    Zb = torch.where(torch.rand((k, C, d, n), generator=gen,
                                                device=dev) < .5, 1., -1.)
                else:
                    xi = torch.randn((k, n), generator=gen, device=dev)
                    Zb = torch.randn((k, C, d, n), generator=gen, device=dev)
                base = 0.1 * torch.randn((k, C, n), generator=gen, device=dev)
                W = 0.1 * torch.randn((k, d * C), generator=gen, device=dev)
                sw = ((torch.rand((k, n), generator=gen, device=dev) < .7)
                      .float() if weighted else None)
                check_newton(f"{kind} k={k} d={d} n={n} weighted={weighted}",
                             kind, Zb, base, xi, W, sw)
        for n, p in ((1001, 37), (333, 130)):
            if kind == "potts":
                x = torch.randint(0, 3, (n, p), generator=gen,
                                  device=dev).float()
                F = torch.stack([(x == c).float() for c in range(1, C + 1)])
            elif kind == "ising":
                F = torch.where(torch.rand((1, n, p), generator=gen,
                                           device=dev) < .5, 1., -1.)
            else:
                F = torch.randn((1, n, p), generator=gen, device=dev)
            th = 0.2 * torch.randn((C, p, p), generator=gen, device=dev)
            th = (th + th.transpose(1, 2)).contiguous()
            mask = (torch.rand((p, p), generator=gen, device=dev) < .1).float()
            mask = ((mask + mask.T) > 0).float()
            bias = 0.1 * torch.randn((C, p), generator=gen, device=dev)
            check_score(f"{kind} n={n} p={p}", kind, F, th, mask, bias)

    # the exact shapes of phases 4 and 5
    timing = []
    timed_ms = {}

    def bucket_inputs(g, fam, X, weighted):
        sess = A.Plan(graph=g, family=fam).session()
        out = []
        for b in sess.buckets:
            nodes = torch.as_tensor(b.nodes, dtype=torch.int64, device=dev)
            nbrs = torch.as_tensor(b.nbrs, dtype=torch.int64, device=dev)
            mask = torch.as_tensor(b.mask, device=dev)
            Zb, xi, base, _ = _bucket_design(
                sess.family, X, nodes, nbrs, mask, None, True)
            k, C, d, n = Zb.shape
            W = 0.05 * torch.randn((k, d * C), generator=gen, device=dev)
            sw = ((torch.rand((k, n), generator=gen, device=dev) < .8)
                  .float() if weighted else None)
            out.append((b.deg_pad, (Zb, base, xi, W, sw)))
        return sess, out

    def newton_cost(Zb, base, xi, W, sw):
        k, C, d, n = Zb.shape
        dC = d * C
        nbytes = sum(t.numel() * t.element_size()
                     for t in (Zb, base, xi, W) + ((sw,) if sw is not None
                                                   else ()))
        nbytes += 4 * (k * dC + k * dC * dC)
        nflop = k * n * (4 * dC + dC * (dC + 1))
        return nbytes, nflop

    def score_cost(C, n, p, nnz):
        """Bytes and FP32 operations of the kernel's contract: the masked
        product counted by the nonzeros of A (its only needed work), the
        full C x C Gram S = r^T F / n that the kernel writes; Theta is read
        once in full (a non-finite entry at a zero of A makes a column
        NaN)."""
        nbytes = 4 * (C * n * p + C * p * p + p * p + C * p + 2 * C * n * p
                      + C * C * p * p)
        nflop = 2 * C * n * nnz + 2 * C * C * n * p * p
        return nbytes, nflop

    def edge_score_cost(C, n, p, nnz):
        """The fit path's own need: fused_pseudo_score reads only the
        channel-diagonal edge entries of S, so eta over the nonzeros of A
        and one length-n dot per directed edge and channel suffice."""
        nbytes = 4 * (C * n * p + C * nnz + C * p + C * nnz)
        nflop = 2 * C * n * nnz + 2 * C * n * nnz
        return nbytes, nflop

    def bound(nbytes, nflop):
        tb, tf = nbytes / bw * 1e3, nflop / flops * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def time_newton(tag, kind, args, reps):
        Zb, base, xi, W, sw = args
        k, C, d, n = Zb.shape
        Z1 = Zb.reshape(k, C * d, n)
        Z1t = Z1.transpose(1, 2).contiguous()
        kms, pms, lms = timer.turns(
            lambda: nmod.bucket_newton_stats_ref(kind, *args),
            lambda: nmod.bucket_newton_stats(kind, *args),
            lambda: torch.bmm(Z1, Z1t), reps)
        bms, by = bound(*newton_cost(*args))
        dms = device_ms(torch, lambda: nmod.bucket_newton_stats(kind, *args),
                        reps)
        row = dict(op="newton", tag=tag, ms=kms, plain_ms=pms,
                   library_ms=lms, bound_ms=bms, bound_by=by)
        timing.append(row)
        timed_ms[f"newton {tag}"] = (kms, dms)
        print(f"  time newton {tag}: kernel {kms:.4f} ms (device {dms:.4f} "
              f"ms), plain {pms:.4f} ms, bmm {lms:.4f} ms, bound {bms:.4f} ms"
              f" ({by})", flush=True)
        return row

    def time_score(tag, kind, F, th, mask, bias, reps):
        C, n, p = F.shape
        B = (th * mask[None]).contiguous()
        _, r, _ = kmod.cl_score_channels_ref(F, th, mask, bias, kind)
        rT = r.transpose(1, 2).contiguous()

        def library():
            torch.matmul(F, B)
            torch.matmul(rT, F)
        kms, pms, lms = timer.turns(
            lambda: kmod.cl_score_channels_ref(F, th, mask, bias, kind),
            lambda: kmod.cl_score_channels(F, th, mask, bias, kind=kind),
            library, reps)
        nnz = int(mask.count_nonzero())
        bms, by = bound(*score_cost(C, n, p, nnz))
        ems, eby = bound(*edge_score_cost(C, n, p, nnz))
        dms = device_ms(torch, lambda: kmod.cl_score_channels(
            F, th, mask, bias, kind=kind), reps)
        row = dict(op="score", tag=tag, ms=kms, plain_ms=pms,
                   library_ms=lms, bound_ms=bms, bound_by=by)
        timing.append(row)
        timed_ms[f"score {tag}"] = (kms, dms)
        print(f"  time score {tag}: kernel {kms:.4f} ms (device {dms:.4f} "
              f"ms), plain {pms:.4f} ms, 2x matmul {lms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}); the fit path's edge-only bound "
              f"{ems:.4f} ms ({eby})", flush=True)
        return row

    main_rows = {}
    for name, g, fam, combs, th, X in paper:
        for weighted in (False, True):
            _, buckets = bucket_inputs(g, fam, X, weighted)
            for deg_pad, args in buckets:
                k, C, d, n = args[0].shape
                tag = f"{name} bucket d={d} k={k} n={n} weighted={weighted}"
                check_newton(tag, fam, *args)
                if not weighted:
                    time_newton(tag, fam, args, 50)
        F, thc, mask, bias = family_kernel_inputs(
            A.Plan(graph=g, family=fam).family_instance, g,
            th.to(dev, torch.float32), X)
        check_score(f"{name} n={X.shape[0]} p={g.p}", fam, F, thc, mask,
                    bias)
        row = time_score(f"{name} n={X.shape[0]} p={g.p} C={F.shape[0]}",
                         fam, F, thc, mask, bias, 50)
        if fam == "potts":
            main_rows["score_cn"] = row
    Xf = X_field[:16384]
    _, buckets = bucket_inputs(g_field, "ising", Xf, False)
    for deg_pad, args in buckets:
        k, C, d, n = args[0].shape
        tag = f"field_ising bucket d={d} k={k} n={n}"
        check_newton(tag, "ising", *args)
        main_rows["newton"] = time_newton(tag, "ising", args, 10)
        # the shape of a stream refit and of an ADMM prox round: per-node
        # prefix weights (half the nodes at 8192 rows, half at 16384), then
        # a ragged slice of it with ragged prefixes
        Zb, base, xi, W, _ = args
        counts = torch.where(torch.arange(k, device=dev) < k // 2, n // 2, n)
        sw = (torch.arange(n, device=dev)[None, :]
              < counts[:, None]).float()
        wargs = (Zb, base, xi, W, sw)
        check_newton(tag + " weighted", "ising", *wargs)
        main_rows["newton_weighted"] = time_newton(tag + " weighted",
                                                   "ising", wargs, 10)
        kr, nr = 333, 5007
        rag = torch.randint(0, nr + 1, (kr,), generator=gen, device=dev)
        check_newton(f"field_ising prox slice d={d} k={kr} n={nr} ragged "
                     f"weights", "ising", Zb[:kr, :, :, :nr].contiguous(),
                     base[:kr, :, :nr].contiguous(),
                     xi[:kr, :nr].contiguous(), W[:kr],
                     (torch.arange(nr, device=dev)[None, :]
                      < rag[:, None]).float())
        del wargs, sw, Zb, base, xi, W
    del buckets
    F, thc, mask, bias = family_kernel_inputs(
        A.Plan(graph=g_field).family_instance, g_field,
        th_field.to(dev, torch.float32), Xf)
    check_score(f"field_ising n={Xf.shape[0]} p={g_field.p}", "ising", F,
                thc, mask, bias)
    main_rows["score_c1"] = time_score(
        f"field_ising n={Xf.shape[0]} p={g_field.p} C=1", "ising", F, thc,
        mask, bias, 3)
    del F, thc, mask, bias
    torch.cuda.empty_cache()

    # ---- plain versions must see no CUDA tensor on the kernel path -------
    plain_cuda_calls = {"n": 0}

    def counting(fn):
        def wrapped(*args, **kwargs):
            if any(getattr(a, "is_cuda", False) for a in args):
                plain_cuda_calls["n"] += 1
            return fn(*args, **kwargs)
        return wrapped

    for mod, name in ((omod, "bucket_newton_stats_ref"),
                      (omod, "cl_score_channels_ref"),
                      (omod, "cl_score_ref"),
                      (nmod, "bucket_newton_stats_ref"),
                      (kmod, "cl_score_channels_ref")):
        setattr(mod, name, counting(getattr(mod, name)))

    launches = {"newton": 0, "score_c1": 0, "score_cn": 0}

    def main_path(sess, X, score_key):
        """One fit on the kernel path with every count set to 0 just
        before it and read just after."""
        nmod.bucket_newton_stats.launches = 0
        kmod.cl_score_channels.launches = 0
        plain_cuda_calls["n"] = 0
        t0 = time.perf_counter()
        res = sess.fit(X)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl = nmod.bucket_newton_stats.launches
        sl = kmod.cl_score_channels.launches
        pc = plain_cuda_calls["n"]
        launches["newton"] += nl
        launches[score_key] += sl
        iters = {}
        sess.fit_local(X, iters=iters)
        gate(nl >= sum(iters.values()) and sl == 1 and pc == 0,
             f"launches: newton {nl} for Newton iterations {iters}, score "
             f"{sl}, plain calls on CUDA tensors {pc}")
        return res, wall

    def finite_result(res, g, fam):
        C = 1 if fam == "ising" else 2
        ok = all(np.all(np.isfinite(v)) and v.shape == ((g.p + g.m) * C,)
                 for v in res.combined.values())
        return ok and np.isfinite(res.score_norm)

    # ---- phase 4: paper scale --------------------------------------------
    print("phase 4: paper scale (Fig. 4, p = 100)")
    for name, g, fam, combs, th, X in paper:
        sess = A.Plan(graph=g, family=fam, combiners=combs).session()
        score_key = "score_c1" if fam == "ising" else "score_cn"
        res, wall = main_path(sess, X, score_key)
        plain_cuda_calls["n"] = 0
        res_plain = sess.fit(X, use_kernel=False)
        gate(plain_cuda_calls["n"] > 0,
             f"{name}: use_kernel=False reached the plain versions "
             f"({plain_cuda_calls['n']} calls)")
        dth = max(float(np.max(np.abs(res.combined[c]
                                      - res_plain.combined[c])))
                  for c in combs)
        dloc = max(float(np.max(np.abs(a.theta - b.theta)))
                   for a, b in zip(res.fits, res_plain.fits))
        gate(dth <= GATE_THETA and finite_result(res, g, fam),
             f"{name}: kernel vs plain fit, combined theta max diff "
             f"{dth:.2e} (local {dloc:.2e}); fit wall {wall:.3f} s, "
             f"score_norm {res.score_norm:.4e}")
        res_small, _ = main_path(sess, X[:1000], score_key)
        truth_np = th.numpy()
        m1 = res_small.combined["diagonal"] - truth_np
        m4 = res.combined["diagonal"] - truth_np
        mse1, mse4 = float(m1 @ m1), float(m4 @ m4)
        gate(mse4 < mse1, f"{name}: diagonal MSE to truth n=1000 "
             f"{mse1:.4f} > n=4000 {mse4:.4f}")
        for c in combs:
            d = res.combined[c] - truth_np
            print(f"  {name} n=4000 {c}: MSE {float(d @ d):.4f}")

    # ---- phase 5: deployment scale ----------------------------------------
    print("phase 5: deployment scale (64 x 64 grid, n = 16384)")
    sess = A.Plan(graph=g_field, family="ising",
                  combiners=FIELD_COMBINERS).session()
    torch.cuda.reset_peak_memory_stats()
    res_cold, cold = main_path(sess, X_field[:16384], "score_c1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    res_warm, warm = main_path(sess, X_field[16384:], "score_c1")
    # the host's pace swings from fit to fit: five more warm fits, on the
    # two halves in turn, give a median and a range
    warms = []
    for i in range(5):
        t0 = time.perf_counter()
        sess.fit(X_field[16384:] if i % 2 == 0 else X_field[:16384])
        torch.cuda.synchronize()
        warms.append(time.perf_counter() - t0)
    print(f"  field fit wall: cold {cold:.3f} s, warm {warm:.3f} s "
          f"(warm new_compiles {res_warm.new_compiles}); peak device memory "
          f"of the cold fit {peak:.2f} GiB")
    print(f"  field warm fit over five more fits: median "
          f"{statistics.median(warms):.4f} s, range {min(warms):.4f}-"
          f"{max(warms):.4f} s", flush=True)
    res_plain = sess.fit(X_field[16384:], use_kernel=False)
    dth = max(float(np.max(np.abs(res_warm.combined[c]
                                  - res_plain.combined[c])))
              for c in FIELD_COMBINERS)
    gate(dth <= GATE_THETA and finite_result(res_cold, g_field, "ising")
         and finite_result(res_warm, g_field, "ising")
         and res_warm.new_compiles == 0,
         f"field: kernel vs plain combined theta max diff {dth:.2e}")
    for c in FIELD_COMBINERS:
        d = res_warm.combined[c] - th_field.numpy()
        print(f"  field n=16384 {c}: MSE {float(d @ d):.4f} over "
              f"{d.size} parameters")

    device_profile(torch, "warm fit", lambda: sess.fit(X_field[16384:]))

    # ---- phase 6: launch counts ------------------------------------------
    gate(all(v > 0 for v in launches.values()),
         f"phase 6: main-path launches {launches}")
    del sess, res_cold, res_warm, res_plain
    torch.cuda.empty_cache()

    # ---- phase 7: flash attention, masked logits, Gram ------------------
    print("phase 7: flash-attention, masked-logits and Gram kernels against "
          "their plain versions on the card")
    import torch.nn.functional as Fn
    import repro_torch.configs as TC
    from repro_torch.kernels.cl.ops import conditional_logits_op
    from repro_torch.kernels.gram import kernel as gmod
    from repro_torch.kernels.gram import ops as gops
    from repro_torch.kernels.swa import kernel as smod
    from repro_torch.kernels.swa import ops as sops
    from repro_torch.models import attention as TA
    from repro_torch.models import decoding as TD
    from repro_torch.models import transformer as TT

    errs.update(swa=0.0, cl_logits=0.0, gram=0.0)

    def bound_at(nbytes, nflop, rate):
        tb, tf = nbytes / bw * 1e3, nflop / rate * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check_swa(tag, q, k, v, window):
        got = smod.swa_attention(q, k, v, window=window)
        same = torch.equal(got, smod.swa_attention(q, k, v, window=window))
        want = smod.swa_attention_ref(q.float(), k.float(), v.float(),
                                      window=window)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        errs["swa"] = max(errs["swa"], abs_err(got, want))
        gate(e <= GATE_SWA[str(q.dtype).split(".")[-1]] and same,
             f"swa {tag} {str(q.dtype).split('.')[-1]}: rel {e:.2e}; a "
             f"second call bitwise equal {same}")
        del got, want

    for dtype in (torch.bfloat16, torch.float32):
        for s_len in (1000, 130):
            for d in (64, 96):
                for h, kh in ((6, 2), (4, 4), (24, 8)):
                    for window in (0, 1, 100):
                        q = randn((2, s_len, h, d), dtype)
                        k, v = (randn((2, s_len, kh, d), dtype)
                                for _ in range(2))
                        check_swa(f"b=2 s={s_len} d={d} h/kh={h}/{kh} "
                                  f"window={window}", q, k, v, window)

    def time_swa(tag, q, k, v, window, reps):
        b, s_len, h, d = q.shape
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            pos = torch.arange(s_len, device=dev)
            band = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)

            def library():
                Fn.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                enable_gqa=True)
        else:
            def library():
                Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True)
        kms, pms, lms = timer.turns(
            lambda: smod.swa_attention_ref(q, k, v, window=window),
            lambda: smod.swa_attention(q, k, v, window=window), library, reps)
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
        nflop = 4 * d * swa_pairs(s_len, window) * b * h
        bms, by = bound_at(nbytes, nflop, bf16_flops)
        row = dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                   bound_by=by)
        timed_ms[f"swa {tag}"] = (kms, None)
        print(f"  time swa {tag}: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
              f"sdpa {lms:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{nflop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
        return row

    llama = TC.get("llama3.2-3b")
    hq, hkv, hd = llama.n_heads, llama.n_kv_heads, llama.hd
    PREFILL = (4, 2048, 32)          # batch, prompt, new tokens
    WINDOWED = (1, 8192, 16, 4096)   # batch, prompt, new tokens, window
    for tag, b, s_len, window, reps in (
            (f"prefill b={PREFILL[0]} s={PREFILL[1]}", PREFILL[0],
             PREFILL[1], 0, 10),
            (f"window b={WINDOWED[0]} s={WINDOWED[1]} w={WINDOWED[3]}",
             WINDOWED[0], WINDOWED[1], WINDOWED[3], 5)):
        q = randn((b, s_len, hq, hd), torch.bfloat16)
        k, v = (randn((b, s_len, hkv, hd), torch.bfloat16) for _ in range(2))
        check_swa(tag, q, k, v, window)
        row = time_swa(tag, q, k, v, window, reps)
        main_rows.setdefault("swa", row)
        del q, k, v
        torch.cuda.empty_cache()

    def check_logits(tag, F, th, mask, bias):
        got = kmod.cl_logits(F, th, mask, bias)
        same = torch.equal(got, kmod.cl_logits(F, th, mask, bias))
        want = kmod.cl_logits_ref(F, th, mask, bias)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        errs["cl_logits"] = max(errs["cl_logits"], abs_err(got, want))
        gate(e <= GATE_ELEM and same, f"cl_logits {tag}: rel {e:.2e}; a "
             f"second call bitwise equal {same}")

    def time_logits(tag, F, th, mask, bias, reps):
        C, n, p = F.shape
        B = (th * mask[None]).contiguous()
        b3 = bias[:, None, :]
        kms, pms, lms = timer.turns(
            lambda: kmod.cl_logits_ref(F, th, mask, bias),
            lambda: kmod.cl_logits(F, th, mask, bias),
            lambda: torch.baddbmm(b3, F, B), reps)
        # a second yardstick: a CSR of (Theta*A)^T times F^T per channel
        # (eta^T without the bias), converted outside the timed region
        csr = [B[c].T.contiguous().to_sparse_csr() for c in range(C)]
        Ft = [F[c].T.contiguous() for c in range(C)]
        sms = timer(lambda: [torch.sparse.mm(csr[c], Ft[c])
                             for c in range(C)], reps)
        del csr, Ft
        nnz = int(mask.count_nonzero())
        # F read, eta written, A, b and Theta read (all of Theta: a
        # non-finite entry at a zero of A makes a column NaN)
        bms, by = bound_at(4 * (2 * C * n * p + p * p + C * p + C * p * p),
                           2 * C * n * nnz, flops)
        dms = device_ms(torch, lambda: kmod.cl_logits(F, th, mask, bias),
                        reps)
        timed_ms[f"cl_logits {tag}"] = (kms, dms)
        print(f"  time cl_logits {tag}: kernel {kms:.4f} ms (device "
              f"{dms:.4f} ms), plain "
              f"{pms:.4f} ms, baddbmm {lms:.4f} ms, sparse.mm {sms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}; the product counted by the {nnz} "
              f"nonzeros of A)", flush=True)
        return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                    bound_by=by, sparse_mm_ms=sms)

    def logits_inputs(C, n, p, density):
        if C == 1:
            F = torch.where(torch.rand((1, n, p), generator=gen, device=dev)
                            < .5, 1.0, -1.0)
        else:
            x = torch.randint(0, C + 1, (n, p), generator=gen, device=dev)
            F = torch.stack([(x == c).float() for c in range(1, C + 1)])
        th = 0.3 * randn((C, p, p))
        mask = (torch.rand((p, p), generator=gen, device=dev)
                < density).float()
        return F, th, mask, 0.1 * randn((C, p))

    for C in (1, 2):
        for p in (37, 130):
            check_logits(f"C={C} n=1001 p={p}", *logits_inputs(C, 1001, p,
                                                               .2))
    for C in (3, 5):
        check_logits(f"C={C} n=333 p=130", *logits_inputs(C, 333, 130, .2))
    sync_args = logits_inputs(2, 333, 130, .2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        kmod.cl_logits(*sync_args)
        kmod.cl_score_channels(*sync_args, kind="potts")
        synced = None
    except RuntimeError as exc:
        synced = str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    gate(synced is None, f"cl_logits and cl_score_channels wrappers make no "
         f"host synchronisation (sync debug mode 'error'): {synced or 'none'}")
    del sync_args
    bench_logits = logits_inputs(1, 4096, 256, .1)   # kernels_bench, full
    check_logits("kernels_bench n=4096 p=256", *bench_logits)
    time_logits("kernels_bench n=4096 p=256", *bench_logits, 20)
    dense = logits_inputs(1, 4096, 1024, 1.0)         # every tile dense
    check_logits("dense n=4096 p=1024", *dense)
    time_logits("dense n=4096 p=1024", *dense, 10)
    del dense
    name, g, fam, _, th, X = paper[2]
    pf = family_kernel_inputs(A.Plan(graph=g, family=fam).family_instance, g,
                              th.to(dev, torch.float32), X)
    check_logits(f"{name} n={X.shape[0]} p={g.p} C={pf[0].shape[0]}", *pf)
    time_logits(f"{name} n={X.shape[0]} p={g.p} C={pf[0].shape[0]}", *pf,
                20)
    ff = family_kernel_inputs(A.Plan(graph=g_field).family_instance, g_field,
                              th_field.to(dev, torch.float32), Xf)
    check_logits(f"field_ising n=16384 p={g_field.p}", *ff)
    main_rows["cl_logits"] = time_logits(
        f"field_ising n=16384 p={g_field.p}", *ff, 3)
    del ff

    def check_gram(tag, S):
        got, want = gmod.gram(S), gmod.gram_ref(S)
        same = torch.equal(got, gmod.gram(S))
        sym = torch.equal(got, got.T)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        errs["gram"] = max(errs["gram"], abs_err(got, want))
        gate(e <= GATE_STATS and same and sym,
             f"gram {tag}: rel {e:.2e} (long sums over samples); a second "
             f"call bitwise equal {same}; bitwise symmetric {sym}")

    for n, d in ((1001, 130), (50, 7), (16384, 513), (5, 512)):
        check_gram(f"n={n} d={d}", randn((n, d)))
    S_bench = randn((16384, 512))                     # kernels_bench, full
    check_gram("kernels_bench n=16384 d=512", S_bench)
    n, d = S_bench.shape
    G0 = torch.empty((d, d), device=dev)
    kms, pms, lms = timer.turns(
        lambda: gmod.gram_ref(S_bench), lambda: gmod.gram(S_bench),
        lambda: torch.addmm(G0, S_bench.T, S_bench, beta=0.0, alpha=1.0 / n),
        20)
    # G is symmetric: d(d+1)/2 dot products of length n
    bms, by = bound_at(4 * (n * d + d * d), n * d * (d + 1), flops)
    main_rows["gram"] = dict(ms=kms, plain_ms=pms, library_ms=lms,
                             bound_ms=bms, bound_by=by)
    timed_ms[f"gram kernels_bench n={n} d={d}"] = (kms, None)
    print(f"  time gram kernels_bench n={n} d={d}: kernel {kms:.4f} ms, "
          f"plain {pms:.4f} ms, addmm {lms:.4f} ms, bound {bms:.4f} ms "
          f"({by})", flush=True)

    # plain versions must see no CUDA tensor on the op entries and serving
    for mod, name in ((omod, "ising_cl_logits_ref"), (kmod, "cl_logits_ref"),
                      (gops, "gram_ref"), (gmod, "gram_ref"),
                      (sops, "swa_attention_ref"),
                      (smod, "swa_attention_ref"),
                      (TA, "_plain_attention"), (TA, "_blocked_attention")):
        setattr(mod, name, counting(getattr(mod, name)))

    F, th, mask, bias = bench_logits
    x, th, bias = F[0], th[0], bias[0]
    kmod.cl_logits.launches = 0
    gmod.gram.launches = 0
    plain_cuda_calls["n"] = 0
    eta = conditional_logits_op(x, th, mask, bias)
    G = gops.gram_op(S_bench)
    torch.cuda.synchronize()
    launches["cl_logits"] = kmod.cl_logits.launches
    launches["gram"] = gmod.gram.launches
    gate(launches["cl_logits"] == 1 and launches["gram"] == 1
         and plain_cuda_calls["n"] == 0 and eta.shape == x.shape
         and G.shape == (d, d) and bool(torch.isfinite(eta).all())
         and bool(torch.isfinite(G).all()),
         f"op entries: conditional_logits_op launched cl_logits "
         f"{launches['cl_logits']}, gram_op launched gram {launches['gram']},"
         f" plain calls on CUDA tensors {plain_cuda_calls['n']}")
    del bench_logits, S_bench, F, x, th, mask, bias, eta, G, G0
    torch.cuda.empty_cache()

    # ---- phase 8: Llama-3.2-3B serving -----------------------------------
    print(f"phase 8: {llama.arch_id} serving at full width and depth "
          f"({llama.n_layers} layers, d={llama.d_model}, {hq}/{hkv} heads, "
          f"{llama.dtype})")
    launches["swa"] = 0
    mgen = torch.Generator(device=dev)
    mgen.manual_seed(32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = TT.model_init(llama, mgen, device=dev)
    torch.cuda.synchronize()

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    n_params = sum(t.numel() for t in leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    print(f"  weights: {n_params / 1e9:.3f} B parameters, "
          f"{weight_bytes / 1e9:.3f} GB, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    b, s_len, n_new = PREFILL
    prompt = torch.randint(0, llama.vocab_size, (b, s_len), generator=mgen,
                           device=dev)
    TD.generate(llama, params, prompt[:1, :64], 2)    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def serve(tag, prompt, n_new, window):
        """generate once through the kernel path, counts set to 0 just
        before and read just after."""
        smod.swa_attention.launches = 0
        plain_cuda_calls["n"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = TD.generate(llama, params, prompt, n_new,
                          window_override=window)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nl, pc = smod.swa_attention.launches, plain_cuda_calls["n"]
        launches["swa"] += nl
        gate(nl == llama.n_layers and pc == 0
             and out.shape == (prompt.shape[0], n_new),
             f"{tag}: generate {tuple(out.shape)} in {wall:.3f} s "
             f"({out.numel() / wall:.1f} tokens/s end to end); "
             f"flash-attention launches {nl} (one prefill of "
             f"{llama.n_layers} layers), plain calls on CUDA tensors {pc}")
        return out

    def breakdown(tag, prompt, n_new, window):
        """Prefill seconds and decode ms per token of the same request."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = TD.prefill(llama, params, prompt,
                                   prompt.shape[1] + n_new,
                                   window_override=window)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits[:, -1]).all())
        last = torch.argmax(logits[:, -1, :llama.vocab_size], -1)[:, None]
        del logits
        step = TD.make_serve_step(llama, window_override=window)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_new - 1):
            last, _, cache = step(params, cache, last, prompt.shape[1] + t)
        torch.cuda.synchronize()
        t_dec = (time.perf_counter() - t0) / (n_new - 1)
        print(f"  {tag}: prefill {t_pre:.4f} s "
              f"({prompt.numel() / t_pre:.0f} prompt tokens/s), decode "
              f"{1e3 * t_dec:.3f} ms per step ({prompt.shape[0] / t_dec:.1f}"
              f" tokens/s at batch {prompt.shape[0]})", flush=True)
        gate(finite, f"{tag}: prefill logits finite")
        return cache

    out1 = serve(f"full attention b={b} prompt={s_len}", prompt, n_new,
                 None)
    out2 = serve(f"full attention b={b} prompt={s_len}, again", prompt,
                 n_new, None)
    gate(torch.equal(out1, out2), "greedy decoding gives identical tokens "
         "on a second run")
    breakdown(f"full attention b={b} prompt={s_len}", prompt, n_new, None)

    extra = 4
    with torch.no_grad():
        tok = torch.cat([prompt, out1[:, :extra]], 1)
        full, _ = TT.forward(llama, params, tok)
        logits, cache = TD.prefill(llama, params, prompt, s_len + extra)

        def rel32(a, c):
            a, c = a.float(), c.float()
            return float((a - c).norm() / c.norm())
        e_pre = rel32(logits, full[:, :s_len])
        finite = bool(torch.isfinite(full).all())
        del logits
        e_dec = []
        for t in range(extra):
            lg, cache = TT.decode_step(llama, params, cache,
                                       tok[:, s_len + t:s_len + t + 1],
                                       s_len + t)
            e_dec.append(rel32(lg[:, 0], full[:, s_len + t]))
        del full, cache
    gate(finite and e_pre <= GATE_SERVE and max(e_dec) <= GATE_SERVE,
         f"prefill + teacher-forced decode against one forward over "
         f"{s_len + extra} tokens: rel prefill {e_pre:.2e}, decode "
         + ", ".join(f"{e:.2e}" for e in e_dec))
    torch.cuda.empty_cache()

    wb, ws, wn, ww = WINDOWED
    prompt_w = torch.randint(0, llama.vocab_size, (wb, ws), generator=mgen,
                             device=dev)
    serve(f"window {ww} b={wb} prompt={ws}", prompt_w, wn, ww)
    cache = breakdown(f"window {ww} b={wb} prompt={ws}", prompt_w, wn, ww)
    klen = cache["units"]["b0"]["k"].shape[2]
    gate(klen == ww, f"window cache holds {klen} positions (window {ww}, "
         f"prompt {ws})")
    del cache
    print(f"  peak device memory of the serving runs "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    device_profile(torch, f"prefill b={b} prompt={s_len}",
                   lambda: TD.prefill(llama, params, prompt, s_len + n_new))
    del params
    torch.cuda.empty_cache()
    phase9(torch, np, A, g_field, th_field.numpy(), X_field, smi, gate,
           launches, plain_cuda_calls, nmod, kmod)
    phase10(torch, np, A, g_field, X_field, smi, gate, launches,
            plain_cuda_calls, nmod, gen, dev, bucket_inputs, check_newton,
            time_newton)
    phase11(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, check_newton, covered)
    phase12(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, g_eu, paper[0][5], g_field, X_field, check_newton, covered)
    phase13(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, kmod,
            dev, g_eu, paper[0][5], g_field, X_field, check_newton, covered)
    phase14(torch, np, A, smi, gate, launches, plain_cuda_calls, nmod, dev,
            g_field, X_field, check_newton, time_newton, bucket_inputs,
            covered)
    phase15(torch, np, smi, gate, launches, plain_cuda_calls, dev, timer,
            bf16_flops, bw)
    launches["swa"] += phase16(torch, smi, gate, plain_cuda_calls, dev,
                               PREFILL, check_swa, time_swa)
    l16, rows16, errs16 = phase17(
        torch, np, A, smi, gate, plain_cuda_calls, dev, timer,
        (bw, flops, bf16_flops), paper[2][1:3] + paper[2][4:6], g_field,
        th_field, X_field)
    launches["swa"] += phase18(torch, smi, gate, plain_cuda_calls, dev,
                               PREFILL, check_swa, time_swa)
    phase19(torch, smi, gate, plain_cuda_calls, dev, PREFILL, timer,
            (bw, flops, bf16_flops))
    launches["swa"] += phase20(torch, smi, gate, plain_cuda_calls, dev,
                               timer, (bw, flops, bf16_flops), check_swa,
                               time_swa)
    launches["swa"] += phase21(torch, np, smi, gate, plain_cuda_calls, dev,
                               timer, bf16_flops)
    launches["swa"] += phase22(torch, np, smi, gate, plain_cuda_calls, dev,
                               timer, (bw, flops, bf16_flops))
    phase23(torch, np, smi, gate, plain_cuda_calls, dev, timer,
            (bw, flops, bf16_flops))
    launches["swa"] += phase24(torch, np, smi, gate, plain_cuda_calls, dev,
                               timer, (bw, flops, bf16_flops))

    kernels = [
        dict(name="bucket_newton_stats", route="cuda",
             source="src/repro_torch/csrc/newton.cu",
             replaces="src/repro/kernels/cl/newton.py:191",
             launches=launches["newton"], max_abs_err=errs["newton"],
             **{k: main_rows["newton"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="cl_score_channels[C=1]", route="cuda",
             source="src/repro_torch/csrc/score.cu",
             replaces="src/repro/kernels/cl/kernel.py:268",
             launches=launches["score_c1"], max_abs_err=errs["score_c1"],
             **{k: main_rows["score_c1"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="cl_score_channels[C>1]", route="cuda",
             source="src/repro_torch/csrc/score.cu",
             replaces="src/repro/kernels/cl/kernel.py:296",
             launches=launches["score_cn"], max_abs_err=errs["score_cn"],
             **{k: main_rows["score_cn"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="swa_attention", route="cuda",
             source="src/repro_torch/csrc/swa.cu",
             replaces="src/repro/kernels/swa/kernel.py:105",
             launches=launches["swa"], max_abs_err=errs["swa"],
             **main_rows["swa"]),
        dict(name="cl_logits", route="cuda",
             source="src/repro_torch/csrc/score.cu",
             replaces="src/repro/kernels/cl/kernel.py:114",
             launches=launches["cl_logits"], max_abs_err=errs["cl_logits"],
             **main_rows["cl_logits"]),
        dict(name="gram", route="cuda",
             source="src/repro_torch/csrc/gram.cu",
             replaces="src/repro/kernels/gram/kernel.py:47",
             launches=launches["gram"], max_abs_err=errs["gram"],
             **main_rows["gram"]),
    ]
    # the bfloat16 operands of phase 17: launches of its entry-point drive
    for key, name, source, replaces in (
            ("score_c1", "cl_score_channels[C=1, bf16]", "score.cu",
             "cl/kernel.py:268"),
            ("score_cn", "cl_score_channels[C>1, bf16]", "score.cu",
             "cl/kernel.py:296"),
            ("cl_logits", "cl_logits[bf16]", "score.cu", "cl/kernel.py:114"),
            ("gram", "gram[bf16]", "gram.cu", "gram/kernel.py:47")):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}", launches=l16[key],
            max_abs_err=errs16[key], **rows16[key]))
    print("redesigned kernels, the first version's time beside this run's "
          "(first versions on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md "
          "kernel table):")
    for tag, before in EARLIER_MS.items():
        now, dev_now = timed_ms.get(tag, (None, None))
        print(f"  {tag}: {before:.4f} ms -> "
              + ("not timed" if now is None else
                 f"{now:.4f} ms ({before / now:.2f}x)")
              + ("" if dev_now is None else f"; device {dev_now:.4f} ms"))
    if failures:
        print(f"chip_smoke: {len(failures)} gate(s) failed:",
              file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
