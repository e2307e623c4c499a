#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dgp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                  # the phases below
    python3 chip_smoke.py --steps [TREE]   # one checkout's Adam steps and
                                           # #1-#4's host cost (steps_main)

Phases, each of which raises (exit code 1) on any fault:

1. build   — compile every CUDA source of the port with nvcc (sm_90a), the
             jobs started together; print the build time, ptxas's register
             and spill report, and the card's name and power limit.
2. kernels — print the widest D of the whitened kernels' plans at M=128;
             hold the fused-conditional kernel (#1) to its plain PyTorch
             version in float64 on the same float32 inputs, for RBF,
             Matern-3/2 and Matern-5/2, at the serving model's layer shapes
             (D=8 and D=1, M=128, Din=8, n=262,181: more tiles than resident
             blocks, a ragged last tile), at a small odd shape (D=3, M=64,
             Din=5), at M = 8, 64, 100, 128 by n = 1, 63, 64, 65, 127, 128,
             129, 1,025 and 262,181 (Din = 8), and in Din = 5 at M = 100
             and 128 by the same n (and one more RBF draw at M = 128,
             n = 1,025) under the witness rule below; each with a
             repeat and a run with NaN above Pinv's diagonal and below Sq's
             bit for bit equal to the first. Then its backward (phase A and phase
             B) likewise, at the training model's layer shapes
             (n = 100,037), the small odd shape, M = 8, 64, 100, 128 by
             n = 1, 63, 64, 65, 129, 1,025 (Din = 8), one point past a
             pass of 2^17 points, at M = 100 and 128 by the same n in
             Din = 5, where Kuu is so ill-conditioned that plain fp32 is
             itself near the tolerance (held to it plus twice that fp32
             error), and with Pinv scaled so that the clamp
             max(var, 0) zeroes part of the variances: all six gradients,
             dPinv and dSq exactly 0 off the patterns of Pinv and Sq, one
             launch of each phase per pass, and a second run bit for bit
             equal to the first; phase B alone (the split-K Grams) at the
             layers' shapes. Then the quadform kernel (#5) and its
             backward (#6, phase A and phase B), with and without t1, at
             the same layer shapes, at two small ones (D=3, M=64 and D=2,
             M=100, which the plans pad to 128), at the BO constraint
             surrogate's (D=1, M=8; n=80 in training, n=30,000 in the
             acquisition), at M = 8, 64, 100, 128 by n = 1, 127, 128, 129
             and 131,109 (a pass of phase B and 37 points more), and on a
             non-whitened layer's own operands at the prior: each with a
             repeat and a run with NaN below Sq's diagonal bit for bit
             equal, dSq exactly 0 below the diagonal, one phase-A and one
             phase-B launch per pass; at the MF model's shapes (D = 1,
             M = 30 by n = 50, 250, 300, 500 and 250,000; M = 5 by n = 50,
             250 and 250,000); and at the Embedded Mapping model's (D = 2,
             M = 6 by n = 300, 600 and 250,000; D = 1, M = 30 by n = 300,
             600, 3,000 and 250,000; D = 1, M = 6 by n = 600 and 250,000).
             Then the Kuf-consuming fused conditional (kernel #3) and its
             backward (#4) on the Kuf and Kff of an RBF + Linear kernel (Kff
             varies per point), at the same four shapes (#3 also at #1's
             edge shapes, with the repeat and NaN runs), the backward's edge
             shapes and M = 50: all five gradients, exact zeros off the
             patterns, and a second run bit for bit equal to the first;
             again at the layer-1 training shape and at M=100 with a Kff
             that makes the clamp max(var, 0) zero many variances; and #3
             at M=100 in 3 input dimensions, which
             conditions Kuu so badly that plain fp32 is itself off f64 by
             more than the tolerance, held to twice that fp32 error. Then
             the Cholesky kernels (#7, the factor; #8, the factor and its
             inverse) on [2, 128, 128] (the whitened models' Kuu stack),
             [3, 24, 24], [1, 8, 8], [1, 100, 100], a [2, 128, 128]
             stack of the models' own Kuu conditioning, a [3, 8, 8]
             stack of the BO surrogate's (8 points on a line), M = 31, 32,
             33, 64, 95, 127 and 129 (either side of each panel edge), a
             [40, 64, 64] stack and the largest M of each plan: L within TOL
             of scale, W also within twice the float32 library pair's error,
             a repeat and a stack with NaN above the diagonal bit for bit
             equal, an indefinite matrix and one whose pivot fails past the
             first panel NaN in place, the Function's gradient against
             autograd in float64; and on the MF Park model's own Kuu stacks
             ([1, 30, 30] at Z, [1, 5, 5] at the recomputed augmented Z,
             White 1e-6 and the float32 jitter 1e-4) and the Park_VD
             model's ([1, 30, 30] at Z, [1, 6, 6] the reduction layer's at
             W, [2, 6, 6] layer 1's at its recomputed 5-D augmented Z with
             the reduction layer's), held to their float64 twins under the
             same jitter; and #7 on the Gram stacks the exact surrogates'
             multi-start engine factors at its first step (8 starts: the
             borehole pair's AR(1) joint Gram [8, 56, 56] and NARGP level
             Grams [8, 40, 40] and [8, 16, 16]; the nonlinear pair's
             [8, 48, 48], [8, 32, 32] and [8, 16, 16]; padding rows with a
             unit diagonal), held to their float64 twins (the nonlinear
             pair's with the witness rule for L too).
3. serving — build the 2-layer whitened RBF DGP of
             benchmarks/predict_throughput.py (DIN=8, HIDDEN=8, M=128, f32,
             S=10) from seeded data with perturbed variational parameters;
             answer 3 predict_y requests of N=100,000 rows plus
             moment_matched, and one request of N=1,000,000 rows through
             predict_in_chunks in chunks of 125,000. The kernels' launch
             counts are zeroed just before and read just after: each request
             must launch the kernel once per layer. Then one request is held
             to the same request with use_kernels off (same unit normals),
             in a process that asks for TF32: the port stays IEEE fp32.
             The same model non-whitened (white=False, the constructor's
             default) answers 3 requests of N=100,000 rows through the
             quadform kernel (one launch per layer, none of the fused
             conditional's) and is held to the kernels-off path likewise.
             bench.py's model with RBF + Linear (ARD) kernels on both layers
             (whitened, q moved off the prior) answers 3 requests of
             N=100,000 rows through kernel #3 (one launch per layer, none
             of #1 or #5), is held to the kernels-off path likewise, and
             its loss gradients too.
4. training — build bench.py's model and data (N=10,000, M=128,
             DIN=HIDDEN=8, S=10, f32, whitened RBF, num_units=[8]) from the
             seed; optimize_adam for 20 steps, optimize_nat_adam for 5 + 10,
             and 2 Adam steps with the kernel hyperparameters and the
             likelihood frozen. Losses finite and falling, frozen tensors
             bit for bit unchanged, forward and backward launch counts as
             the step counts predict (zeroed just before, read just after).
             Then one loss-and-gradient evaluation on fixed unit normals with
             the kernels on against the kernels off. The same model
             non-whitened, from its prior (q_sqrt = chol(Kuu)): 10 Adam steps
             and 3 + 5 Adam+natural-gradient steps through the quadform
             kernels; and the same gradient comparison on a non-whitened copy
             with q moved off the prior. bench.py's model with RBF + Linear
             kernels, whitened: 10 Adam steps and 3 + 5 Adam+natural-gradient
             steps through kernels #3 and #4 only. On every path each
             request and loss evaluation factors its Kuu stack once through
             #8 (a non-whitened KL takes the same factor).
5. bo      — compat/validate_bo.py --dgp through the port's SO_BO on the
             card: min (x-0.5)^2 s.t. step(x-0.25) <= 0, DoE 5, seed 7, a
             GPR objective surrogate and a num_layers=2 DGP constraint
             surrogate, EI with EV handling, DE + Adam; cut to 2 infills,
             100 training iterations, DE 60 x 40 and 50 Adam steps. The
             Ymin trace finite, non-increasing and at or above 0.0625; the
             launches of #5-#8 equal to those reckoned from the loop; the
             final surrogates' predictions with the kernels on and off, each
             against the same prediction in float64;
             seconds per infill, split into training and acquisition.
6. mf      — compat/validate_mf_dgp.py through the port's
             MultiFidelityDeepGP on the card (the nb_mfdgp_improved Park
             pair: Din = 4, N = 30 / 5, Z = X, S = 10, float32; layers of
             M = 30 and 5 through #5-#8): build it,
             optimize_nat_adam(lr_adam=0.005) for 20 + 20 + 40 steps (cut
             from --fast's 300 / 400 / 800), a fresh model's optimize_adam
             for 10 + 10 + 10, one predict of 1,000 rows at 250 samples.
             Losses finite and falling; each phase's frozen tensors bit for
             bit unchanged (z_left moving from phase 2, the likelihood and
             q in phase 3); the launches of #5-#8 equal to those reckoned
             from the loops; a request and a loss gradient on fixed unit
             normals with the quadform kernels on and off within 1e-3 of
             scale (z_left's gradient nonzero); the request also with every
             kernel on and off (use_kernels) within 1e-3, and each of the
             two against the same request in float64.
7. em      — compat/validate_mf_dgp_em.py through the port's
             MultiFidelityDeepGP_EM on the card (the nb_mfdgpem Park_VD
             pair: a 2-D low fidelity of N = 30, a 4-D high fidelity of
             N = 6, X_red = X[1][:, :2], Z = X, W = [X[1]], S = 100,
             float32; a reduction layer of D = 2, M = 6 and layers of
             M = 30 and 6 through #5-#8): build it,
             optimize_nat_adam(lr_adam=0.005) for 10 + 10 + 40 steps (cut
             from --fast's 0 / 400 / 800), a fresh model's optimize_adam for
             10 + 10 + 10, one predict of 1,000 rows at 250 samples. As the
             mf phase, with em_moves: the reduction layer's z moving from
             phase 1, its q_sqrt in the natural-gradient phase 3 only, both
             likelihoods frozen but for the model likelihood in Adam's
             phase 3; launches as em_expected_counts reckons them; the
             request and the loss gradient (z_left's, the reduction layer's
             z and q_mu's and the projection likelihood's nonzero) with the
             kernels on and off, and the request against float64.
8. exact_mf — the exact multi-fidelity surrogates through the port's
             AR1CoKriging and NARGP on the card in float32: the borehole
             pair of benchmarks/mf_bo_bakeoff.py (d = 8, a DoE of 40 low
             and 10 high rows drawn as MF_BO draws one, Y under its pooled
             normalization, n_bucket 8), each optimize(8 starts, 2,000 Adam
             steps, lr 0.05): every engine step factors the 8 starts'
             Grams in one launch of #7 (launches reckoned from the loop),
             the winner the least finite final NLL and no higher than
             start 0's; the loss and gradient at the init and at the
             trained parameters with #7 on and off and against float64
             (at the trained ones, where the gradient vanishes, each entry
             against the magnitudes of the terms it sums); predict_f and
             predict_y of 1,000 rows (NARGP at 100 samples); one EI
             maximization each by DE 60 x 40 + 50 Adam steps, AR(1)'s EI
             at the maximizer against float64. The nonlinear pair of
             tests/test_nargp.py (f_high = f_low^2) at its budget (8 x
             1,500): held-out r2(NARGP) > 0.9 and r2(AR(1)) < 0.5. The EI
             loss and its gradient in x over the mf and em phases' models.
9. mf_bo   — the multi-fidelity BO driver through the port's MF_BO on the
             card in float32: benchmarks/mf_bo_bakeoff.py's Forrester cell
             (d = 1, DoE 8 + 4, seed 1) with the default AR(1) surrogate
             cut to 8 starts x 300 steps, DE 60 x 40, 100 samples: three
             infills (the third by suggest() and observe()), a batch of two
             with a believer lie, and one PoF infill under g(x) = 0.55 - x
             (its constraint GPR cut to 300 Adam steps); one infill each of
             the NARGP surrogate, of the MF-DGP (schedule (20, 10, 10), a
             batch of two: the lie's 200-step warm refit through #5/#6/#8)
             and of MF-DGP-EM on Park_VD 30/6 (x[:, :2] the projection).
             Each infill's seconds split into surrogate fit, constraint
             fits, acquisition, fidelity rule and lies, and its #7
             launches; the archives real evaluations only, the cost and
             fidelity accounting, the best trace finite, non-increasing and
             at or above the Forrester minimum; the launches of #5-#8 equal
             to those reckoned from the loop's operations (recorded_loop,
             reckon_loop); at the AR(1) and MF-DGP batch states the
             fidelity rule's sigma and the believer lies with the kernels on
             and off and against float64; the device idle share of one
             AR(1) infill (torch.profiler).
10. mo      — the multi-objective deep GP through the port's
             MultiObjDeepGP on the card (compat/validate_mo_dgp.py's
             multi_obj_1D_4: 10 LHS points, x and both objectives
             normalized, the default Z, loop 2, S = 10, float32; layers of
             D = 1, M = 10 through #5-#8): #5/#6 at its shapes (M = 10 by
             n = 100, 500, 1,000 and 250,000) with the repeat and NaN runs,
             #7/#8 on its Kuu stacks ([1, 10, 10], [2, 10, 10]) against
             their float64 twins; optimize_nat_adam(restarts=1) for
             10 + 10 + 20 steps (cut from the default run's 200 / 300 /
             800), a fresh model's optimize_adam for 10 + 10 + 10, one
             predict of 1,000 rows at 250 samples, held as the mf phase
             (mo_moves: q is not checked under natural gradients, whose
             steps from this init mostly leave the natural-parameter cone);
             launches as mo_expected_counts reckons them, the guard's
             evaluations counted; one optimize_nat_adam(restarts="auto",
             max_restarts=2): a second schedule where the first's fit
             score is below 0.9, the kept parameters bit for bit the best
             candidate's, the launches reckoned per schedule; the request
             and the loss gradient (layer 0's z and z_left's nonzero) with
             the kernels on and off (the witness rule) and against float64.
11. mo_bo   — the multi-objective BO driver through the port's MO_BO on
             the card in float32 (multi_obj_1D_4 at 10 LHS points, seed 0,
             n_bucket 8): #5/#6 at its shapes (D = 1, M = 16 by n = 80,
             200, 800, 1,600, 12,000 and 300,000) with the repeat and NaN
             runs, #7/#8 on its stacks (the coupled model's Kuu [1, 16, 16]
             and [2, 16, 16], a DGP's [2, 16, 16], a GPR's padded Gram
             [1, 16, 16]) against their float64 twins; the native Pareto
             sweep built and its front on a 4,096-row archive the numpy
             loop's, in its order both ways; the default GPR pair cut to 300 Adam steps, DE 60 x 40
             then 50 Adam steps at S 200: three infills (the second a batch
             of two, the third by suggest() and observe()), a save and a
             load, and one more infill of the loaded loop bit for bit the
             unsaved loop's; one constrained infill on bnh (EHVI x PoF, its
             constraint GPRs cut to 300 steps) and one on an all-infeasible
             srn DoE (the PoF-only bootstrap); one infill of the coupled
             MO-DGP (schedule (20, 0, 0), restarts=1) and a batch of two of
             the DGP pair (schedule (20, 0); the lie's 200-step warm refit).
             Each infill's seconds split into surrogate fit, constraint
             fits, DE, Adam and lies; the archives real evaluations only,
             the hypervolume never falling and ending above its start (the
             GPR pair); the launches of #5-#8 equal to those reckoned from
             the loop's recorded operations (recorded_mo_loop,
             reckon_mo_loop); at four batch states EHVI of 1,000 fixed rows
             on fixed unit normals by each estimator (and, constrained,
             -(EHVI x PoF)) with the kernels on and off and against float64
             (the plain versions' term capped at 1e-2, the GPR pair's at
             5e-2);
             the ms of one EHVI evaluation of 300 rows at S 1,000 of each
             form; the device idle share of one GPR pair infill; one uncut
             default infill (2,000 Adam steps, DE 300 x 400, Adam 1,000).
12. cls     — the non-conjugate heads (Gauss-Hermite quadrature) through
             the port's DGP on the card in float32: #5/#6 at the shapes
             below (CLS_QUADFORM: the classifier's D = 2 and 1 at M = 30,
             n = 600 and 20,000; the Student-t model's D = 1, M = 20,
             n = 240 and 6,000; compat_torch/validate_dgp_regression.py's
             D = 1, M = 25, n = 500) with the repeat and NaN runs, #7/#8 on
             the three models' Kuu stacks ([2, 30, 30], [2, 20, 20],
             [3, 25, 25]) against their float64 twins; the classifier of
             compat_torch/validate_classification.py (120 rows in 2-D,
             Z = X[::4], hidden width 2, non-whitened, Bernoulli, S 5):
             optimize_adam for 100 steps (cut from 800), predict and
             predict_density of the 200 held-out rows at 100 samples
             (probabilities in [0, 1]); a fresh classifier through
             optimize_nat_adam for 10 + 10 steps (natural gradients on
             both layers' q under the non-conjugate head, each q_mu
             moving); the classifier whitened, 10 Adam steps and a request
             through #1/#2; the Student-t model of
             compat_torch/validate_robust_regression.py (60 rows with 10 %
             outliers, Z = X[::3], S 4) through optimize_nat_adam for
             20 + 30 steps (cut from 300 + 700, natural gradients on the
             last layer) and a predict of its rows. Losses finite and
             falling; the launches of #1-#8 after each step as
             cls_expected_counts reckons them; each trained model's request
             and loss gradient on fixed unit normals with the kernels on
             and off (the witness rule for the gradients) and the request
             against float64.
13. parallel — data parallelism over torch.distributed at full width: a
             world-size-1 NCCL process group in this process, bench.py's
             whitened model on its mesh (10 Adam, 3 + 5 Adam+natural-gradient
             steps, a 100,000-row predict_y_sharded request whole and in
             chunks of 25,000, held to the unsharded request by a band of
             its Monte-Carlo error), the non-whitened model, a 128-row GPR
             (#7), MF, EM and MO: each one sharded loss-and-gradient against
             the unsharded one on one recorded draw (each rank its rows'
             share) within PAR_TOL plus twice float32's own error against
             float64, and one request (the 1-layer and GPR requests held to
             the unsharded ones within PAR_TOL); then two spawned gloo ranks
             sharing cuda:0 (the whitened, non-whitened and MF
             losses-and-gradients, the 1-layer request, 2 Adam steps whose
             parameters and gradients must be bit-equal across the ranks).
             Launches as reckoned from each rank's rows; ms per sharded Adam
             step and request beside the unsharded ones, and profiles.
14. examples — every section of examples_torch/ (quickstart, serving,
             ask_tell, classification, mf_bo, mo_bo) on the card in float32
             at budgets cut from the examples' (EX_*: steps, infills, DE
             sizes; widths, samples and rows as the examples have them),
             and the README's recipes (examples_torch/recipes.py): (a)
             benchmarks/large_scale.py's N = 1,000,000 rows, B = 10,000, S =
             10, a whitened RBF [8] model on a world-size-1 mesh, at M = 128
             (#1/#2) and at M = 256 (every plan refuses it: no launch), its
             Adam steps timed and profiled; (b) a checkpoint written inside
             a natural-gradient phase, reloaded bit for bit into a fresh
             model that trains on; (c) SO_BO saved after 2 infills, loaded
             and run 1 more, equal bit for bit to the uninterrupted 3. #5 and
             #6 at the examples' own shapes (EX_QUADFORM) with the repeat and
             NaN runs, #7/#8 on the quickstart DGP's and serving's Kuu
             stacks against their float64 twins. The examples' own asserts;
             losses finite and falling; serving's whole and chunked
             requests within 1e-6 of scale on zero normals; best traces
             finite and never rising; the launches of #1-#8 after each
             section as reckoned (the BO loops' from their recorded
             operations: recorded_so_bo, recorded_loop, recorded_mo_loop).
15. timing — CUDA-event times of every kernel and of its plain version at
             the layers' shapes (forwards n = 1,000,000, backwards
             n = 100,000), beside the bound of the work these inputs
             need at the rates of the kernel's route (#2/#4/#6 also phase
             A, phase B and the reductions apart, from torch.profiler; #2/#4
             also phase B alone); #1 (all three kinds) and #3 also at
             n = 100,000; #1, #3 and #5 with the profiler's device time, and
             beside the fp32 bound too (their products b_d run on the
             tensor cores); #3 and #5 against their plain versions at
             n = 10,000;
             #7 and #8 at the models' and the BO's stacks, and #7 at the
             exact surrogates' engine stacks [8, 56, 56] and [8, 40, 40],
             beside the library calls for the same function (cholesky_ex,
             and solve_triangular for #8), event-timed and, from
             torch.profiler, the device time of the kernel and of the
             library's kernels; the engine's wall ms per step (8 starts);
             bench.py's whitened model's precompute_projections and Adam step with the factorizations
             through the kernels, their plain versions, and the checked
             torch.linalg.cholesky the port called before;
             wall time per Adam step and per Adam+natural-gradient step
             (whitened RBF) and per Adam step (non-whitened, RBF + Linear);
             the device time by kernel over one request and over three Adam
             steps of each of the three models (torch.profiler); the MF,
             EM and MO models' ms per loss-and-gradient evaluation and per
             1,000-row predict, the cls phase's three models' per
             loss-and-gradient and per request at 100 samples, and their
             device idle share over three Adam steps.

The line before the last is one JSON object listing every ported kernel
(and, as entries of their own, the phase B of #2 and of #4; #6's phase B
launches stand in its entry);
the last line is {"ok": true, "device": {...}}. Without a card, or without
the rest of the repository beside it, the script fails before printing
either.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12    # dense, on the tensor cores
PEAK_BYTES = 3.35e12
KINDS = {0: "RBF", 1: "Matern32", 2: "Matern52"}
DIN, HIDDEN, M, S = 8, 8, 128, 10
N_REQUEST, N_CHUNKED, CHUNK = 100_000, 1_000_000, 125_000
N_TRAIN = 10_000    # bench.py's N; a layer's conditional sees S * N_TRAIN points
ADAM_STEPS, NAT_STEPS_1, NAT_STEPS_2, MASKED_STEPS = 20, 5, 10, 2
NONWHITE_ADAM_STEPS, NONWHITE_NAT_STEPS = 10, (3, 5)
COMPOSITE_ADAM_STEPS, COMPOSITE_NAT_STEPS = 10, (3, 5)
TOL = 1e-4          # kernel vs f64 plain: mean err / max|mean|, var err / v
                    # (max Kff: the variance cancels against it), t2 (t1)
                    # err / max|t2| (max|t1|)
# backward kernel vs f64 plain: err / max|that gradient|. dvariance is one
# number, a signed sum of n*D terms of the size of g_var that largely cancel,
# so it is held to sum|g_var| instead of its own (small) value
TOL_BWD = 1e-4
# kernels on vs off, one loss gradient on fixed normals: two fp32 paths, as
# for the request
TOL_GRAD = 1e-3
# kernel on vs off at the request level: both paths are float32 but sum in
# other orders (cuBLAS vs the kernel's sequential FMA); layer 1's rounding
# reaches layer 2 through the sampled inputs and the v - ||A||^2
# cancellation, so the request is held at 1e-3 of its scale
TOL_REQUEST = 1e-3
# where a float32 factorization of an ill-conditioned Kuu is itself off
# float64 by more than TOL_REQUEST, the kernels' arm may be off by twice the
# library arm's error, but never by more than this much of scale
WITNESS_CAP = 1e-2
# the whitened kernels' (#1-#4) edge shapes: the plans pad M to 64 or 128,
# the forwards and phase A take tiles of 128 points and phase B slices of
# 1,024; 262,181 points make more tiles than resident blocks, the last one
# ragged
EDGE_M = (8, 64, 100, 128)
BACKWARD_EDGE_N = (1, 63, 64, 65, 129, 1_025)
FORWARD_EDGE_N = (1, 63, 64, 65, 127, 128, 129, 1_025, 262_144 + 37)
# the quadform's (#5/#6) edge points: its tiles of 128 points, and one pass
# of #6's phase B (2^17 points) and 37 more
QUADFORM_EDGE_N = (1, 127, 128, 129, 131_072 + 37)
# 100 or 128 inducing inputs drawn in 5 dimensions make Kuu so
# ill-conditioned (RBF: max|Pinv| 65-83) that plain fp32 is itself near
# TOL_BWD of scale off float64 in dXs: #1 and #2 are held there to TOL (or
# TOL_BWD) plus twice plain fp32's error on the same draw (the witness rule
# of #3's M = 100, Din = 3 case)
WITNESS_M = (100, 128)
# #7/#8 checks either side of each edge of their 16-column panels
CHOLESKY_EDGES = (31, 32, 33, 64, 95, 127, 129)
# the multi-fidelity configuration (compat/validate_mf_dgp.py, the notebook
# nb_mfdgp_improved): Park, Din = 4, N = 30 / 5 from lhs seeds 123 / 124,
# Z = X, S = 10, float32; requests of 1,000 rows (lhs seed 125) at 250
# samples; training cut from --fast's 300 / 400 / 800 steps
MF_DIN, MF_N, MF_S = 4, (30, 5), 10
MF_REQUEST, MF_PREDICT_S = 1_000, 250
MF_NAT, MF_ADAM = (20, 20, 40), (10, 10, 10)
# its quadform shapes (D, M, n), D = 1: layer 0 (M = 30) at 50 x 5 (Z_right
# in a loss or request), 100 x 5 (at init), 10 x 30 (the fidelity-0 term),
# 10 x 5 (the fidelity-1 term) and 250 x 1,000 points (a request); layer 1
# (M = 5) at 10 x 5, 250 and 250 x 1,000 points: M off every multiple of 8
# that the other checks take
MF_QUADFORM = [(1, 30, 250), (1, 30, 300), (1, 30, 250_000), (1, 30, 50),
               (1, 30, 500), (1, 5, 50), (1, 5, 250), (1, 5, 250_000)]
# the multi-fidelity configuration with Embedded Mapping
# (compat/validate_mf_dgp_em.py, the notebook nb_mfdgpem): Park_VD, a 2-D
# low fidelity of 30 points (lhs seed 123) and a 4-D high fidelity of 6
# (lhs seed 0), X_red = X[1][:, :2], Z = X, W = [X[1]], S = 100, float32;
# requests of 1,000 rows (lhs seed 321) at 250 samples; training cut from
# --fast's 0 / 400 / 800 steps at lr_adam 0.01 to 10 / 10 / 40 at 0.005
# (phase 1 kept: it moves the reduction layer's inducing inputs alone; at
# 0.01 the first steps of phase 2 raise the loss 35-fold, a CPU rehearsal)
EM_DIN, EM_N, EM_S = (2, 4), (30, 6), 100
EM_REQUEST, EM_PREDICT_S = 1_000, 250
EM_NAT, EM_ADAM = (10, 10, 40), (10, 10, 10)
# its quadform shapes (D, M, n): the reduction layer (D = 2, M = 6) at
# 50 x 6 points (Z_right in a loss or request), 100 x 6 (at init, the
# projection term and the fidelity-1 term) and 250 x 1,000 (a request);
# layer 0 (D = 1, M = 30) at 50 x 6, 100 x 6, 100 x 30 (the fidelity-0
# term) and 250 x 1,000; layer 1 (D = 1, M = 6, its composite kernel on the
# 5-D augmented Z) at 100 x 6 and 250 x 1,000: D = 2 at an M below 8, which
# no other path runs
EM_QUADFORM = [(2, 6, 300), (2, 6, 600), (2, 6, 250_000), (1, 30, 300),
               (1, 30, 600), (1, 30, 3_000), (1, 30, 250_000), (1, 6, 600),
               (1, 6, 250_000)]
# the exact multi-fidelity surrogates: the borehole pair of
# benchmarks/mf_bo_bakeoff.py (d = 8, a DoE of 40 low and 10 high rows drawn
# as MF_BO draws a DoE, Y under its pooled normalization; n_bucket 8; the
# bake-off's training, 8 starts x 2,000 Adam steps at lr 0.05), requests of
# 1,000 rows (NARGP at 100 samples)
XMF_D, XMF_DOE, XMF_BUCKET = 8, (40, 10), 8
XMF_STARTS, XMF_ITERATIONS, XMF_LR = 8, 2_000, 0.05
XMF_REQUEST, XMF_S = 1_000, 100
# tests/test_nargp.py's nonlinear pair (f_high = f_low^2, f_low =
# sin(8 pi x); 30 low and 10 high rows) at its budget (8 starts x 1,500
# steps) and oracle: on 200 held-out points at 300 samples r2(NARGP) > 0.9
# and r2(AR(1)) < 0.5
NONLINEAR_DOE, NONLINEAR_ITERATIONS = (30, 10), 1_500
NONLINEAR_TEST, NONLINEAR_S = 200, 300
# the multi-fidelity BO driver: benchmarks/mf_bo_bakeoff.py's Forrester cell
# (d = 1, DoE 8 + 4, MF_BO's default AR(1) surrogate of 8 starts x 2,000
# Adam steps, DE 300 x 400, 500 samples, 10 infills) at seed 1, cut to
# 8 starts x 300 steps, DE 60 x 40 and 100 samples; the constraint GPR
# (g(x) = 0.55 - x) cut from 2,000 Adam steps to 300, the variational forms'
# schedule from (200, 200, 400) to (20, 10, 10)
MFBO_DOE, MFBO_SEED, MFBO_STEPS = (8, 4), 1, 300
MFBO_SPECS = {
    "ar1": {"type": "ar1", "n_starts": 8, "iterations": MFBO_STEPS},
    "nargp": {"type": "nargp", "n_starts": 8, "iterations": MFBO_STEPS,
              "num_samples": 100},
    "mf_dgp": {"schedule": (20, 10, 10)},
    "em": {"type": "em", "schedule": (20, 10, 10)},
}
MFBO_CON = {"kernels": "rbf", "iterations": MFBO_STEPS}
MFBO_RUN = dict(popsize_DE=60, iterations_DE=40, num_samples=100,
                verbose=False)
# the high fidelity's minimum is -6.020740 (the bake-off's f*): no best value
# may lie below it
FORRESTER_FLOOR = -6.0208
MFBO_ROWS = 21               # rows of the fidelity rule's and lies' checks
# the multi-objective configuration (compat/validate_mo_dgp.py, the notebook
# nb_modgp): multi_obj_1D_4 at 10 LHS points (seed 0), x and both objectives
# normalized, the default Z ([X, Y_1] and X), loop 2, S 10, float32;
# requests of 1,000 rows (lhs seed 7, normalized as x) at 250 samples;
# training cut from the default run's 200 / 300 / 800 natural-gradient
# steps to 10 / 10 / 20 (restarts=1, the published single run) and Adam to
# 10 / 10 / 10; one restarts="auto" run of at most MO_RESTARTS schedules
MO_N, MO_LOOP, MO_S = 10, 2, 10
MO_REQUEST, MO_PREDICT_S = 1_000, 250
MO_NAT, MO_ADAM, MO_RESTARTS = (10, 10, 20), (10, 10, 10), 2
MO_THRESHOLD = 0.9           # optimize_nat_adam's restart_threshold
# its quadform shapes (D, M, n), D = 1 and M = 10 on both layers: 10 x 10
# points (a loss's conditionals), 50 x 10 (Z_right in a loss or request, and
# the restart score's conditionals), 100 x 10 (Z_right at init) and
# 250 x 1,000 (a request)
MO_QUADFORM = [(1, 10, 100), (1, 10, 500), (1, 10, 1_000), (1, 10, 250_000)]
# the multi-objective BO driver (phase 11): MO_BO on multi_obj_1D_4 at 10
# LHS points (seed 0, n_bucket 8); its default GPR pair cut from 2,000 Adam
# steps to 300 (the constraint GPRs on bnh too), the search from DE
# 300 x 400 (S 1,000) to DE 60 x 40 then 50 Adam steps at S 200; the
# coupled MO-DGP (no 'type': loop 2, 5 samples) at schedule (20, 0, 0)
# (default (100, 0, 0)) with restarts=1; the DGP pair (one hidden layer,
# 5 samples) at (20, 0) (default (100, 0)), its lies' warm refit at the
# default 200 steps
MOBO_N, MOBO_SEED, MOBO_STEPS = 10, 0, 300
MOBO_GPR = {"type": "independent", "num_layers": 0, "kernels": "rbf",
            "iterations": MOBO_STEPS}
MOBO_CON = {"kernels": "rbf", "iterations": MOBO_STEPS}
MOBO_COUPLED = {"schedule": (20, 0, 0), "restarts": 1}
MOBO_DGP = {"type": "independent", "num_layers": 1, "kernels": "rbf",
            "schedule": (20, 0)}
MOBO_RUN = dict(method="DE+Adam", popsize_DE=60, iterations_DE=40,
                iterations_adam=50, S=200, verbose=False)
MOBO_UNCUT = dict(method="DE+Adam", popsize_DE=300, iterations_DE=400,
                  iterations_adam=1000, S=1000, verbose=False)
MOBO_ROWS, MOBO_EHVI_S = 1_000, 200   # the on-vs-off checks' rows, samples
# the cap on the plain versions' term of the GPR pair's EHVI checks: near
# the archive's rows a GPR's posterior variance is ~1e-4 and its Gram's
# condition number ~1e5, so float32 EHVI is itself ~1e-2 of the largest
# value off float64 whichever factorization runs (1.06e-2 on an H100, the
# kernels on vs off 1.12e-2); WITNESS_CAP for every other state
MOBO_GPR_CAP = 5e-2
MOBO_ESTIMATORS = [("None", False), ("Gaussian", False), ("Gaussian", True),
                   ("KDE", False)]
# its quadform shapes (D, M, n), D = 1 and M = 16 (the padded inducing
# rows): a training loss (5 samples x 16 rows), an Adam step's EHVI
# (200 x 1), a Z_right (50 x 16) and the init's (100 x 16), a DE
# generation's EHVI (200 x 60) and the uncut one's (1,000 x 300)
MOBO_QUADFORM = [(1, 16, 80), (1, 16, 200), (1, 16, 800), (1, 16, 1_600),
                 (1, 16, 12_000), (1, 16, 300_000)]
# the classification configuration (compat_torch/validate_classification.py):
# 120 training and 200 held-out rows (seeds 0 and 1) of two bands in 2-D,
# Z = X[::4] (M = 30), two RBF layers (hidden width 2, non-whitened), the
# probit Bernoulli head, S 5, Adam at lr 0.02 cut from 800 steps to 100;
# requests of the held-out rows at 100 samples; natural gradients 10 + 10
# steps on a fresh classifier; the classifier whitened (#1/#2), 10 Adam
# steps and a request. The Student-t configuration
# (compat_torch/validate_robust_regression.py): 60 rows with 10 % outliers,
# Z = X[::3] (M = 20), hidden width 1, S 4, optimize_nat_adam cut from
# 300 + 700 steps to 20 + 30, a predict of its rows at 100 samples
CLS_N, CLS_TEST, CLS_S, CLS_SAMPLES = 120, 200, 5, 100
CLS_ADAM, CLS_NAT, CLS_WHITE_ADAM = 100, (10, 10), 10
T_N, T_S, T_NAT = 60, 4, (20, 30)
# their quadform shapes (D, M, n): the classifier's layers (D = 2 and 1,
# M = 30) at 5 x 120 points (a loss) and 100 x 200 (a request); the
# Student-t model's (D = 1, M = 20) at 4 x 60 and 100 x 60; the
# nb_DGP_regression model of compat_torch/validate_dgp_regression.py
# (D = 1, M = 25) at 10 x 50
CLS_QUADFORM = [(2, 30, 600), (2, 30, 20_000), (1, 30, 600), (1, 30, 20_000),
                (1, 20, 240), (1, 20, 6_000), (1, 25, 500)]
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 1 --------------------------------------------------------------------


def build():
    from dgp_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} source(s), nvcc jobs started together, in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        kernel = ""
        for line in (text or "").splitlines():
            entry = re.search(r"Compiling entry function .*?("
                              r"[a-z][a-z_]*_(?:fwd|bwd)(?:_a)?|"
                              r"reduce_parts|gram_finish|cholesky_kernel)"
                              r"(I(?:L[ib]\d+E)+E)?", line)
            if entry:
                args = re.findall(r"L[ib](\d+)E", entry.group(2) or "")
                kernel = entry.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name} {kernel}: {line.strip()}")


# -- phase 2 --------------------------------------------------------------------


def fused_inputs(kind, D, Mi, Din, n, seed, device):
    """Seeded float32 inputs of the fused conditional, with non-trivial
    variational parameters (q_mu ~ N(0,1), q_sqrt = tril(0.05 N + I))."""
    from dgp_tpu_torch.ops import conditionals as C
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    pool = rng.uniform(size=(2000, Din))
    Z = torch.tensor(pool[rng.choice(2000, Mi, replace=False)], **f32)
    X = torch.tensor(rng.uniform(size=(n, Din)), **f32)
    q_mu = torch.tensor(rng.normal(size=(Mi, D)), **f32)
    q_sqrt = torch.tensor(
        np.tril(0.05 * rng.normal(size=(D, Mi, Mi)) + np.eye(Mi)), **f32)
    kern = getattr(K, KINDS[kind]).create(variance=1.3, lengthscales=[1.0] * Din,
                                          **f32)
    with torch.no_grad():
        proj = C.precompute_projection(kern, Z, q_sqrt, True)
        ls = kern.lengthscales
        return (proj.Pinv, X / ls, Z / ls, kern.variance.detach(), q_mu,
                torch.tril(q_sqrt).transpose(-1, -2))


def with_nan_below(Sq):
    """Sq with NaN below its diagonal, where tril(q_sqrt)^T holds zeros: the
    kernels read only Sq's upper triangle, so their results must keep their
    bits."""
    below = torch.ones(Sq.shape[-2:], dtype=torch.bool, device=Sq.device).tril(-1)
    return Sq.masked_fill(below, float("nan"))


def with_garbage(Pinv, Sq):
    """Pinv with NaN above its diagonal and Sq with NaN below its own: the
    whitened kernels read only the lower triangle of Pinv and the upper one
    of Sq, so their results must keep their bits."""
    return Pinv.masked_fill(torch.ones_like(Pinv, dtype=torch.bool).triu(1),
                            float("nan")), with_nan_below(Sq)


def check_repeats(what, run, args, pinv_at, sq_at, outputs):
    """``run(*args)`` again, and on a copy of args with NaN off the patterns
    of Pinv (args[pinv_at]) and Sq (args[sq_at]): both bit for bit equal to
    ``outputs``."""
    dirty = list(args)
    dirty[pinv_at], dirty[sq_at] = with_garbage(args[pinv_at], args[sq_at])
    for label, inputs in (("a repeat", args), ("NaN off the patterns", dirty)):
        with torch.no_grad():
            again = run(*inputs)
        sync()
        if not all(torch.equal(a, b) for a, b in zip(outputs, again)):
            raise AssertionError(f"{what}: {label} changed the output bits")


def check_kernel(kind, D, Mi, Din, n, seed, witness=False):
    """Kernel #1 against its plain version in float64 on the same float32
    inputs: mean within TOL of max|mean|, var within TOL of v; a repeat and
    a run with NaN above Pinv's diagonal and below Sq's bit for bit equal.
    With ``witness`` the inputs are conditioned so badly that the plain
    version in float32 is itself near TOL of float64; each output is then
    held to TOL of its scale plus twice that plain fp32 error."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, Mi, Din, n, seed, DEVICE)
    before = cfr.FusedConditional.launches
    run = lambda *a: cfr.fused_conditional_white_stationary(kind, *a)
    with torch.no_grad():
        mk, vk = run(*args)
        sync()
        mp, vp = cfr.fused_conditional_plain(kind, *[a.double() for a in args])
        m32, v32 = (cfr.fused_conditional_plain(kind, *args) if witness
                    else (mp, vp))
    if cfr.FusedConditional.launches != before + 1:
        raise AssertionError("the fused conditional did not launch its kernel")
    if (mk.shape != (n, D) or not torch.isfinite(mk).all()
            or not torch.isfinite(vk).all()):
        raise AssertionError(f"{KINDS[kind]}: bad shape or non-finite kernel output")
    check_repeats(f"{KINDS[kind]} D={D} M={Mi} n={n}", run, args, 0, 5, (mk, vk))
    v = float(args[3])
    em = float((mk.double() - mp).abs().max())
    ev = float((vk.double() - vp).abs().max())
    scale_m = float(mp.abs().max())
    tol_m, tol_v = TOL * scale_m, TOL * v
    extra = f", {em / scale_m:.2e} / {ev / v:.2e} of scale (mean / var)"
    if witness:
        em32 = float((m32.double() - mp).abs().max())
        ev32 = float((v32.double() - vp).abs().max())
        tol_m, tol_v = tol_m + 2 * em32, tol_v + 2 * ev32
        extra += (f", plain fp32 {em32:.3e} / {ev32:.3e}, max|Pinv| "
                  f"{float(args[0].abs().max()):.1f} [tol: TOL of scale + 2x "
                  f"plain fp32]")
    ok = em <= tol_m and ev <= tol_v
    log(f"[kernels] {KINDS[kind]:8s} D={D} M={Mi} Din={Din} n={n}: "
        f"max|dmean| {em:.3e} (tol {tol_m:.3e}), max|dvar| {ev:.3e} (tol "
        f"{tol_v:.3e}){extra}; repeat and NaN off the patterns bit-equal "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{KINDS[kind]} kernel disagrees with its plain version")
    return max(em, ev)


BACKWARD_OUTPUTS = ("dPinv", "dXs", "dZs", "dvariance", "dq_mu", "dSq")


def pass_edge():
    """One point past the first pass of the whitened backward's points."""
    from dgp_tpu_torch.ops import _launch

    return _launch.BACKWARD_PASS + 1


def off_pattern(name, grad):
    """Entries of a whitened backward's dPinv (above the diagonal) or dSq
    (below it) that are not exactly 0: the kernels return them on the
    patterns of Pinv (lower) and Sq (upper)."""
    if name == "dPinv":
        return int(torch.triu(grad, 1).count_nonzero())
    if name == "dSq":
        return int(torch.tril(grad, -1).count_nonzero())
    return 0


def check_passes(cls, before, n, what):
    """One phase-A and one phase-B launch of a whitened backward per pass of
    its points since ``before`` = (backward_launches, gram_launches)."""
    from dgp_tpu_torch.ops import _launch

    passes = -(-n // _launch.BACKWARD_PASS)
    got = (cls.backward_launches - before[0], cls.gram_launches - before[1])
    if got != (passes, passes):
        raise AssertionError(f"{what}: phase A / phase B launches {got}, "
                             f"expected {passes} each")


def stationary_clamp(kind, args):
    """The fused conditional's float32 operands with Pinv scaled so that
    the clamp max(var, 0) zeroes part of the variances: var = (v - t1) + t2
    with t1 and t2 scaling as Pinv^2, the scale puts v at the median of the
    positive t1 - t2_d (reckoned in float64)."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    Pinv, Xs, Zs, v, q_mu, Sq = [a.double() for a in args]
    with torch.no_grad():
        _, _, A = cfr._sq_kuf_a(kind, Pinv, Xs, Zs, v)
        u = (A * A).sum(0) - ((Sq @ A) ** 2).sum(1)   # [D, n]
        scale = float(torch.sqrt(v / u[u > 0].median()))
    return (args[0] * scale, *args[1:])


def stationary_band(kind, args):
    """(lin, band) of the fused conditional as :func:`clamp_band` gives them
    for kernel #3: the float64 pre-clamp variances (v - t1) + t2 [D, n] and
    the band |lin| <= TOL * v."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    Pinv, Xs, Zs, v, q_mu, Sq = [a.double() for a in args]
    with torch.no_grad():
        _, _, A = cfr._sq_kuf_a(kind, Pinv, Xs, Zs, v)
        lin = (v - (A * A).sum(0)) + ((Sq @ A) ** 2).sum(1)
    return lin, TOL * float(v)


def check_backward(kind, D, Mi, Din, n, seed, clamp=False, witness=False):
    """Kernel #2 (phase A and phase B) through autograd of the wrapper,
    against the plain backward in float64 on the same float32 inputs (both
    give dPinv on Pinv's lower and dSq on Sq's upper pattern): each of the
    six gradients within TOL_BWD of its own largest magnitude, the entries
    off those patterns exactly 0, one launch of each phase per pass of
    points, and a second run on the same inputs bit for bit equal to the
    first (every sum in a fixed order). With ``clamp`` Pinv is scaled so
    that the clamp zeroes part of the variances (:func:`stationary_clamp`);
    where a pre-clamp variance lies within TOL * v of 0, kernel and plain
    version may take the mask on opposite sides, so g_var is 0 there. With
    ``witness`` the inputs are conditioned so badly that the plain version
    in float32 is itself near TOL_BWD of float64; each gradient is then
    held to TOL_BWD of its scale plus twice that plain fp32 error on the
    same inputs."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, Mi, Din, n, seed, DEVICE)
    if clamp:
        args = stationary_clamp(kind, args)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = [torch.randn((n, D), generator=gen, device=DEVICE) for _ in range(2)]
    lin, band = stationary_band(kind, args)
    ambiguous = lin.T.abs() <= band
    g[1] = g[1].masked_fill(ambiguous, 0.0)
    clamped = int((lin <= 0).sum())
    if clamp and not 0 < clamped < n * D:
        raise AssertionError(f"{KINDS[kind]} clamp case: {clamped} of {n * D} "
                             f"variances clamped")
    FC = cfr.FusedConditional

    def kernel_grads():
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = (FC.backward_launches, FC.gram_launches)
        out = cfr.fused_conditional_white_stationary(kind, *leaves)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g)
        sync()
        check_passes(FC, before, n, f"{KINDS[kind]} n={n}")
        return grads

    got = kernel_grads()
    again = kernel_grads()
    with torch.no_grad():
        want = cfr.fused_conditional_backward_plain(
            kind, *[a.double() for a in args], *[x.double() for x in g])
        # the plain version in float32 on the same inputs: how far fp32
        # itself lands from f64 at this Kuu's conditioning
        plain32 = (cfr.fused_conditional_backward_plain(kind, *args, *g)
                   if witness else want)
    worst, report = 0.0, []
    for name, a, b, w, p in zip(BACKWARD_OUTPUTS, got, again, want, plain32):
        if a.shape != w.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{KINDS[kind]} {name}: bad shape or non-finite")
        if not torch.equal(a, b):
            raise AssertionError(f"{KINDS[kind]} {name}: two runs differ")
        if off_pattern(name, a):
            raise AssertionError(f"{KINDS[kind]} {name}: {off_pattern(name, a)} "
                                 f"nonzero entries off the pattern")
        err = float((a.double() - w).abs().max())
        scale = (float(g[1].abs().sum()) if name == "dvariance"
                 else float(w.abs().max()))
        tol = TOL_BWD * scale
        report.append(f"{name} {err / scale:.2e}")
        if witness:
            err32 = float((p.double() - w).abs().max())
            tol += 2 * err32
            report[-1] += f" (plain fp32 {err32 / scale:.2e})"
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(
                f"{KINDS[kind]} D={D} M={Mi} Din={Din} n={n}: {name} off by "
                f"{err:.3e}, {err / scale:.2e} of its scale {scale:.3e}")
    log(f"[kernels] backward {KINDS[kind]:8s} D={D} M={Mi} Din={Din} n={n} "
        f"seed {seed}: err / max|plain f64| (dvariance: / sum|g_var|; tol "
        f"{TOL_BWD}{' of scale + 2x plain fp32' if witness else ''}): "
        f"max|Pinv| {float(args[0].abs().max()):.1f}; "
        f"{', '.join(report)}; {clamped} of {n * D} variances clamped, "
        f"{int(ambiguous.sum())} within {band:.2e} of the clamp (g_var 0 "
        f"there); off-pattern zeros, repeat bit-equal ok")
    return worst


def gram_inputs(D, Mi, n, seed):
    """Seeded float32 operands of a whitened backward's phase B: A, dA, Kuf
    [M, n] ~ N(0, 1), gv [D, n] ~ N(0, 1) with a third of it 0 (the clamp
    mask) and Sq upper-triangular."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    A, dA, Kuf = (torch.randn((Mi, n), generator=gen, **f32) for _ in range(3))
    gv = torch.randn((D, n), generator=gen, **f32)
    gv = gv * (torch.rand((D, n), generator=gen, **f32) > 1 / 3)
    Sq = torch.triu(torch.randn((D, Mi, Mi), generator=gen, **f32)) / Mi ** 0.5
    return A, dA, Kuf, gv, Sq


def check_gram(module, D, Mi, n, seed):
    """Phase B of a whitened backward alone (``module``'s gram_backward:
    the split-K Grams, their reduction and dSq = triu(2 Sq C)), against its
    plain version in float64 on the same float32 inputs: dPinv and dSq
    within TOL_BWD of their largest magnitude, exact zeros off the
    patterns, a repeat bit for bit equal."""
    args = gram_inputs(D, Mi, n, seed)
    with torch.no_grad():
        got = module.gram_backward(*args)
        again = module.gram_backward(*args)
        sync()
        want = module.gram_backward_plain(*[a.double() for a in args])
    worst, report = 0.0, []
    for name, a, b, w in zip(("dPinv", "dSq"), got, again, want):
        if (a.shape != w.shape or not torch.isfinite(a).all()
                or not torch.equal(a, b) or off_pattern(name, a)):
            raise AssertionError(f"{module.__name__} phase B {name}: bad shape, "
                                 f"non-finite, off the pattern or not repeatable")
        err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
        report.append(f"{name} {err / scale:.2e}")
        worst = max(worst, err)
        if not err <= TOL_BWD * scale:
            raise AssertionError(f"{module.__name__} phase B D={D} M={Mi} n={n}: "
                                 f"{name} off by {err / scale:.2e} of its scale")
    log(f"[kernels] phase B of {module.__name__.split('.')[-1]} D={D} M={Mi} "
        f"n={n}: err / max|plain f64| (tol {TOL_BWD}): {', '.join(report)}; "
        f"off-pattern zeros, repeat bit-equal ok")
    return worst


def quadform_inputs(D, Mi, n, seed, device):
    """Seeded float32 Sq (upper-triangular, as tril(q_sqrt)^T is on the
    conditional's path), A [M, n] and cotangents g2 [D, n], g1 [n]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    Sq = torch.triu(torch.randn((D, Mi, Mi), generator=gen, **f32)) / Mi ** 0.5
    A = torch.randn((Mi, n), generator=gen, **f32)
    g2 = torch.randn((D, n), generator=gen, **f32)
    g1 = torch.randn((n,), generator=gen, **f32)
    return Sq, A, g2, g1


def prior_quadform_inputs(D, Mi, n, seed, device):
    """A non-whitened layer's quadform operands at the prior, where its
    training starts, in float32: A = Kuu^-1 Kuf of an RBF kernel
    (lengthscale 1) on Mi inducing and n points drawn in 3 input
    dimensions, Kuu with the float32 jitter 1e-4 (reckoned in float64), and
    Sq = tril(q_sqrt)^T with q_sqrt = chol(Kuu) in every output, so that
    b_d = Sq[d] a = Lu^-1 kuf; g2, g1 ~ N(0, 1). (On the CPU at M = 100,
    n = 1,037: max|a| 1.29, max t2 1.00, plain float32 1.0e-6 of it off
    float64: no witness rule is needed.)"""
    rng = np.random.default_rng(seed)
    Z, X = rng.uniform(size=(Mi, 3)), rng.uniform(size=(n, 3))
    rbf = lambda P, Q: np.exp(-0.5 * ((P[:, None] - Q[None]) ** 2).sum(-1))
    Kuu = rbf(Z, Z) + 1e-4 * np.eye(Mi)
    A = np.linalg.solve(Kuu, rbf(Z, X))
    Sq = np.broadcast_to(np.linalg.cholesky(Kuu).T, (D, Mi, Mi))
    f32 = dict(dtype=torch.float32, device=device)
    return tuple(torch.tensor(np.ascontiguousarray(x), **f32) for x in (
        Sq, A, rng.normal(size=(D, n)), rng.normal(size=(n,))))


def held(what, name, got, want, tol):
    """(err, report) of one output against its float64 plain version: a
    finite float32 tensor of its shape with err <= tol * max|want|; raises
    otherwise."""
    if got.dtype != torch.float32:
        raise AssertionError(f"{what} {name}: dtype {got.dtype}, not float32")
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what} {name}: bad shape or non-finite")
    err, scale = float((got.double() - want).abs().max()), float(want.abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: {name} off by {err:.3e}, {err / scale:.2e} "
                             f"of its scale {scale:.3e}")
    return err, f"{name} {err / scale:.2e}"


def check_quadform(D, Mi, n, with_t1, seed, prior=False, inputs=None):
    """Kernel #5 against its plain version in float64 on the same float32
    inputs: t2 within TOL of max|t2|, and t1 within TOL of max|t1|; a repeat
    and a run with NaN below Sq's diagonal bit for bit equal to the first.
    With ``prior`` the inputs are a non-whitened layer's at the prior
    (:func:`prior_quadform_inputs`), else :func:`quadform_inputs`, unless
    ``inputs`` gives (Sq, A, g2, g1) on the card."""
    from dgp_tpu_torch.ops import quadform as qf

    make = prior_quadform_inputs if prior else quadform_inputs
    Sq, A, _, _ = inputs or make(D, Mi, n, seed, DEVICE)
    run = lambda s: qf.QuadForm.apply(s, A, with_t1)
    before = qf.QuadForm.launches
    with torch.no_grad():
        runs = [run(Sq), run(Sq), run(with_nan_below(Sq))]
        sync()
        want = (qf.quadform_t2_t1_reference(Sq.double(), A.double()) if with_t1
                else (qf.quadform_t2_reference(Sq.double(), A.double()),))
    if qf.QuadForm.launches != before + 3:
        raise AssertionError("the quadform did not launch its kernel")
    got, again, dirty = (r if with_t1 else (r,) for r in runs)
    what = f"quadform D={D} M={Mi} n={n}"
    worst, report = 0.0, []
    for name, g, a, b, w in zip(("t2", "t1"), got, again, dirty, want):
        if not (torch.equal(g, a) and torch.equal(g, b)):
            raise AssertionError(f"{what}: a repeat or NaN below Sq's diagonal "
                                 f"changed {name}'s bits")
        err, line = held(what, name, g, w, TOL)
        worst = max(worst, err)
        report.append(line)
    log(f"[kernels] quadform{' +t1' if with_t1 else ''} D={D} M={Mi} n={n}"
        f"{' at the prior' if prior else ''}: err / max|plain f64| (tol {TOL}): "
        f"{', '.join(report)}; repeat and NaN below Sq's diagonal bit-equal ok")
    return worst


def check_quadform_backward(D, Mi, n, with_t1, seed, prior=False,
                            inputs=None):
    """Kernel #6 (phase A and phase B) through autograd of the wrapper,
    against the plain backward in float64 on the same float32 inputs
    (those of :func:`check_quadform`): dSq and dA each within TOL_BWD of its
    largest magnitude, dSq exactly 0 below the diagonal, one phase-A launch
    and one phase-B launch per pass of points, and a repeat and a run with
    NaN below Sq's diagonal bit for bit equal to the first."""
    from dgp_tpu_torch.ops import _launch
    from dgp_tpu_torch.ops import quadform as qf

    make = prior_quadform_inputs if prior else quadform_inputs
    Sq, A, g2, g1 = inputs or make(D, Mi, n, seed, DEVICE)
    cotangents = (g2, g1) if with_t1 else (g2,)
    QF = qf.QuadForm
    what = f"quadform backward D={D} M={Mi} n={n}"

    def kernel_grads(sq):
        leaves = [sq.clone().requires_grad_(True), A.clone().requires_grad_(True)]
        before = (QF.backward_launches, QF.gram_launches)
        out = QF.apply(*leaves, with_t1)
        grads = torch.autograd.grad(out, leaves, grad_outputs=cotangents)
        sync()
        launched = (QF.backward_launches - before[0], QF.gram_launches - before[1])
        if launched != (1, -(-n // _launch.BACKWARD_PASS)):
            raise AssertionError(f"{what}: phase A / phase B launches {launched}")
        return grads

    got, again, dirty = (kernel_grads(Sq), kernel_grads(Sq),
                         kernel_grads(with_nan_below(Sq)))
    d = lambda x: x.double()
    with torch.no_grad():
        want = qf.quadform_backward_plain(d(Sq), d(A), d(g2),
                                          d(g1) if with_t1 else None)
    worst, report = 0.0, []
    for name, g, a, b, w in zip(("dSq", "dA"), got, again, dirty, want):
        if not (torch.equal(g, a) and torch.equal(g, b)):
            raise AssertionError(f"{what}: a repeat or NaN below Sq's diagonal "
                                 f"changed {name}'s bits")
        if off_pattern(name, g):
            raise AssertionError(f"{what}: {off_pattern(name, g)} nonzero "
                                 f"entries of {name} below the diagonal")
        err, line = held(what, name, g, w, TOL_BWD)
        worst = max(worst, err)
        report.append(line)
    log(f"[kernels] quadform backward{' +t1' if with_t1 else ''} D={D} M={Mi} "
        f"n={n}{' at the prior' if prior else ''}: err / max|plain f64| (tol "
        f"{TOL_BWD}): {', '.join(report)}; dSq zero below the diagonal, repeat "
        f"and NaN below Sq's diagonal bit-equal ok")
    return worst


def composite_kernel(Din, device=DEVICE):
    """The configuration's layer kernel: RBF + Linear, both ARD over the
    layer's Din inputs, at bench.py's initial values (variances and
    lengthscales 1)."""
    from dgp_tpu_torch.ops import kernels as K

    f32 = dict(dtype=torch.float32, device=device)
    return (K.RBF.create(variance=1.0, lengthscales=[1.0] * Din, **f32)
            + K.Linear.create(variance=[1.0] * Din, **f32))


def composite_inputs(D, Mi, Din, n, seed, device=DEVICE, kern=None,
                     clamp=False):
    """Seeded float32 operands of kernel #3 for a composite layer kernel
    (``kern``, by default :func:`composite_kernel`): Pinv, Kuf = K(Z, X),
    q_mu ~ N(0, 1), Sq = tril(0.05 N + I)^T and Kff = K_diag(X), which
    varies per point (1 + sum_l x_l^2 for RBF + Linear). With ``clamp``,
    Kff is instead set per point to max_d(t1 - t2_d) + U(-1, 1) (reckoned
    in float64), so that the clamp max(var, 0) zeroes many variances (a
    quarter to two fifths of them at this script's shapes)."""
    from dgp_tpu_torch.ops import conditional_fused as cf
    from dgp_tpu_torch.ops import conditionals as C

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    pool = rng.uniform(size=(2000, Din))
    Z = torch.tensor(pool[rng.choice(2000, Mi, replace=False)], **f32)
    X = torch.tensor(rng.uniform(size=(n, Din)), **f32)
    q_mu = torch.tensor(rng.normal(size=(Mi, D)), **f32)
    q_sqrt = torch.tensor(
        np.tril(0.05 * rng.normal(size=(D, Mi, Mi)) + np.eye(Mi)), **f32)
    kern = composite_kernel(Din, device) if kern is None else kern
    with torch.no_grad():
        proj = C.precompute_projection(kern, Z, q_sqrt, True)
        args = [proj.Pinv, kern.K(Z, X), q_mu,
                torch.tril(q_sqrt).transpose(-1, -2), kern.K_diag(X)]
        if clamp:
            _, _, t1, t2 = cf._a_b(*[args[i].double() for i in (0, 1, 3)])
            offset = torch.tensor(rng.uniform(-1, 1, n), dtype=torch.float64,
                                  device=device)
            args[4] = ((t1 - t2).max(dim=0).values + offset).float()
    return tuple(args)


def clamp_band(args):
    """(lin, band): the float64 pre-clamp variances (Kff - t1) + t2 [D, n]
    of these float32 operands, and the band |lin| <= TOL * max Kff within
    which the kernel (float32) and the plain version (float64) may take the
    clamp max(lin, 0) on opposite sides: it is the variance's own
    tolerance."""
    from dgp_tpu_torch.ops import conditional_fused as cf

    Pinv, Kuf, _, Sq, Kff = [a.double() for a in args]
    with torch.no_grad():
        _, _, t1, t2 = cf._a_b(Pinv, Kuf, Sq)
    return (Kff - t1) + t2, TOL * float(Kff.max())


def check_fused_white(D, Mi, Din, n, seed, clamp=False, witness=False):
    """Kernel #3 against its plain version in float64 on the same float32
    inputs: mean within TOL of max|mean|, var within TOL of max Kff. With
    ``clamp`` (see :func:`composite_inputs`) some variances must be clamped
    to 0. With ``witness`` the inputs are conditioned so badly that the
    plain version in float32 is itself beyond TOL of float64; the kernel is
    then held to twice that plain fp32 error plus TOL of scale. A repeat
    and a run with NaN above Pinv's diagonal and below Sq's must give the
    same bits."""
    from dgp_tpu_torch.ops import conditional_fused as cf

    args = composite_inputs(D, Mi, Din, n, seed, clamp=clamp)
    before = cf.FusedConditionalWhite.launches
    with torch.no_grad():
        mk, vk = cf.fused_conditional_white(*args)
        sync()
        launched = cf.FusedConditionalWhite.launches - before
        check_repeats(f"kernel #3 D={D} M={Mi} n={n}", cf.fused_conditional_white,
                      args, 0, 3, (mk, vk))
        mp, vp = cf.fused_conditional_white_plain(*[a.double() for a in args])
        # the plain version in float32 on the same inputs: how far fp32
        # itself lands from f64 at this Kuu's conditioning
        m32, v32 = cf.fused_conditional_white_plain(*args)
    if launched != 1:
        raise AssertionError("the fused whitened conditional did not launch its kernel")
    if (mk.shape != (n, D) or not torch.isfinite(mk).all()
            or not torch.isfinite(vk).all()):
        raise AssertionError("kernel #3: bad shape or non-finite output")
    em = float((mk.double() - mp).abs().max())
    ev = float((vk.double() - vp).abs().max())
    scale_m, kff = float(mp.abs().max()), float(args[4].max())
    em32 = float((m32.double() - mp).abs().max())
    ev32 = float((v32.double() - vp).abs().max())
    tol_m, tol_v = TOL * scale_m, TOL * kff
    if witness:
        tol_m, tol_v = tol_m + 2 * em32, tol_v + 2 * ev32
    clamped = int((vp == 0).sum())
    ok = (em <= tol_m and ev <= tol_v
          and (not clamp or 0 < clamped < n * D))
    log(f"[kernels] fused whitened (#3) D={D} M={Mi} Din={Din} n={n}, Kff in "
        f"[{float(args[4].min()):.2f}, {kff:.2f}], max|Pinv| "
        f"{float(args[0].abs().max()):.1f}, {clamped} of {n * D} variances "
        f"clamped: max|dmean| {em:.3e} (tol {tol_m:.3e}; plain fp32 "
        f"{em32:.3e}), max|dvar| {ev:.3e} (tol {tol_v:.3e}; plain fp32 "
        f"{ev32:.3e})"
        f"{' [tol: TOL of scale + 2x plain fp32]' if witness else ''}"
        f"; repeat and NaN off the patterns bit-equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel #3 disagrees with its plain version")
    return max(em, ev)


FUSED_WHITE_GRADS = ("dPinv", "dKuf", "dq_mu", "dSq", "dKff")


def check_fused_white_backward(D, Mi, Din, n, seed, clamp=False):
    """Kernel #4 (phase A and phase B) through autograd of the wrapper,
    against the plain backward in float64 on the same float32 inputs (both
    give dPinv on Pinv's lower and dSq on Sq's upper pattern): each of the
    five gradients within TOL_BWD of its own largest magnitude (dKff, the
    clamp-masked sum of g_var over the outputs, per point), the entries off
    those patterns exactly 0, one launch of each phase per pass of points,
    and a second run bit for bit equal to the first. Where a pre-clamp
    variance lies within :func:`clamp_band` of 0, kernel and plain version
    may take the mask on opposite sides; g_var is
    set to 0 there, so the mask of those entries reaches no gradient, and
    they are counted. With ``clamp`` some variances must be clamped, so the
    mask zeroes part of g_var."""
    from dgp_tpu_torch.ops import conditional_fused as cf

    args = composite_inputs(D, Mi, Din, n, seed, clamp=clamp)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    g = [torch.randn((n, D), generator=gen, device=DEVICE) for _ in range(2)]
    lin, band = clamp_band(args)
    ambiguous = lin.T.abs() <= band
    g[1] = g[1].masked_fill(ambiguous, 0.0)
    clamped = int((lin <= 0).sum())
    if clamp and not 0 < clamped < n * D:
        raise AssertionError(f"kernel #4 clamp case: {clamped} of {n * D} "
                             f"variances clamped")

    FW = cf.FusedConditionalWhite

    def kernel_grads():
        leaves = [a.clone().requires_grad_(True) for a in args]
        before = (FW.backward_launches, FW.gram_launches)
        out = cf.fused_conditional_white(*leaves)
        grads = torch.autograd.grad(out, leaves, grad_outputs=g)
        sync()
        check_passes(FW, before, n, f"kernel #4 n={n}")
        return grads

    got, again = kernel_grads(), kernel_grads()
    with torch.no_grad():
        want = cf.fused_conditional_white_backward_plain(
            *[a.double() for a in args], *[x.double() for x in g])
    worst, report = 0.0, []
    for name, a, b, w in zip(FUSED_WHITE_GRADS, got, again, want):
        if a.shape != w.shape or not torch.isfinite(a).all():
            raise AssertionError(f"kernel #4 {name}: bad shape or non-finite")
        if not torch.equal(a, b):
            raise AssertionError(f"kernel #4 {name}: two runs differ")
        if off_pattern(name, a):
            raise AssertionError(f"kernel #4 {name}: {off_pattern(name, a)} "
                                 f"nonzero entries off the pattern")
        err, scale = float((a.double() - w).abs().max()), float(w.abs().max())
        report.append(f"{name} {err / scale:.2e}")
        worst = max(worst, err)
        if not err <= TOL_BWD * scale:
            raise AssertionError(
                f"kernel #4 D={D} M={Mi} n={n}: {name} off by {err:.3e}, "
                f"{err / scale:.2e} of its scale {scale:.3e}")
    log(f"[kernels] fused whitened backward (#4) D={D} M={Mi} Din={Din} "
        f"n={n}: err / max|plain f64| (tol {TOL_BWD}): {', '.join(report)}; "
        f"{clamped} of {n * D} variances clamped, {int(ambiguous.sum())} "
        f"within {band:.2e} of the clamp (g_var 0 there); off-pattern zeros, "
        f"repeat bit-equal ok")
    return worst


def spd_stack(G, Mi, seed, kuu=None):
    """Seeded float32 [G, Mi, Mi] symmetric positive-definite stack: B B^T /
    Mi + 0.1 I (condition number ~1e2); with ``kuu="model"`` the layers' own
    Kuu, an RBF (unit variance and lengthscales) of Mi points drawn in DIN
    dimensions, plus the float32 jitter 1e-4 (max|Kuu^-1| in the thousands);
    with ``kuu="bo"`` the BO surrogate's, the same RBF of Mi points on a
    line, standardized as SO_BO standardizes its inputs (the jitter sets
    the condition number)."""
    rng = np.random.default_rng(seed)
    if kuu is not None:
        if kuu == "bo":
            Z = rng.uniform(size=(G, Mi, 1))
            Z = (Z - Z.mean(axis=1, keepdims=True)) / Z.std(axis=1, keepdims=True)
        else:
            Z = rng.uniform(size=(G, Mi, DIN))
        d2 = np.sum((Z[:, :, None] - Z[:, None]) ** 2, axis=-1)
        A = np.exp(-0.5 * d2) + 1e-4 * np.eye(Mi)
    else:
        B = rng.normal(size=(G, Mi, Mi))
        A = B @ np.swapaxes(B, -1, -2) / Mi + 0.1 * np.eye(Mi)
    return torch.tensor(A, dtype=torch.float32, device=DEVICE)


def check_cholesky(G, Mi, seed, inverse, kuu=None, stack=None,
                   witness=False):
    """Kernel #7 (or #8) against its plain version in float64 on the same
    float32 stack: L within TOL of max|L|; W within TOL of max|W| plus twice
    the error of the float32 library pair (cholesky_ex + solve_triangular)
    on the same inputs, which the conditioning alone sets (the witness
    rule of the #3 checks); a second run and a run on the stack with NaN
    above every diagonal (only the lower triangle is read) bit for bit
    equal to the first; an
    indefinite matrix in the stack, and (for Mi > 40) one positive definite
    in its leading 40 x 40 block but not overall, whose failed pivot lies
    past the first panel, give NaN there (L on and below the diagonal, all
    of W) and leave the others' bits unchanged; and, on the
    well-conditioned stacks,
    the Function's gradient within TOL_BWD of autograd through
    torch.linalg.cholesky and solve_triangular in float64. With ``stack``
    = (A, A64), a model's own float32 Kuu stack and its float64 twin (the
    same kernel in float64 under the float32 jitter, :func:`park_kuu`), the
    reference is the plain version on the twin. With ``witness`` (a model's
    ill-conditioned Gram, whose float32 entries alone move L off the twin's
    by more than TOL: the nonlinear pair's, exact_grams), L too is held by
    the witness rule, TOL plus twice the float32 library's error."""
    from dgp_tpu_torch.ops import cholesky as tch

    A = spd_stack(G, Mi, seed, kuu) if stack is None else stack[0]
    what = f"{'#8 chol+inverse' if inverse else '#7 chol'} G={G} M={Mi}" + (
        f" ({kuu} Kuu)" if kuu else "")
    fn = tch.CholeskyInverse if inverse else tch.Cholesky
    before = fn.launches
    with torch.no_grad():
        got = tch._launch(A, inverse)
        again = tch._launch(A, inverse)
        sync()
        want = tch.cholesky_inverse_plain(A.double() if stack is None
                                          else stack[1])
        lib32 = tch.cholesky_inverse_plain(A)
    if fn.launches != before + 2:
        raise AssertionError(f"{what}: the kernel did not launch")
    got, again = (got, again) if inverse else ((got,), (again,))
    junk = A.clone()
    upper = torch.ones(Mi, Mi, dtype=torch.bool, device=DEVICE).triu(1)
    junk[:, upper] = float("nan")
    with torch.no_grad():
        outs = tch._launch(junk, inverse)
    outs = outs if inverse else (outs,)
    if not all(torch.equal(o, g) for o, g in zip(outs, got)):
        raise AssertionError(f"{what}: the run with NaN above the diagonal differs")
    worst, report = 0.0, []
    for name, g, r, w, p in zip(("L", "W"), got, again, want, lib32):
        if not (torch.equal(g, r) and torch.isfinite(g).all()):
            raise AssertionError(f"{what}: {name} non-finite, or two runs differ")
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        err32 = float((p.double() - w).abs().max())
        limit = TOL * scale + (2 * err32 if name == "W" or witness else 0.0)
        report.append(f"{name} {err / scale:.2e} (library fp32 "
                      f"{err32 / scale:.2e}, limit {limit / scale:.2e})")
        worst = max(worst, err)
        if not err <= limit:
            raise AssertionError(f"{what}: {name} off by {err:.3e} of scale "
                                 f"{scale:.3e}, limit {limit:.3e}")

    k = G // 2
    bad = A.clone()
    lam = torch.linalg.eigvalsh(A[k].double()).min()
    bad[k] -= (float(lam) + 1.0) * torch.eye(Mi, device=DEVICE)
    failures = [("indefinite", bad)]
    if Mi > 40:
        late = A.clone()
        late[k, 40, 40] = -1.0  # the first 40 pivots pass, the 41st fails
        failures.append(("pivot-40-fails", late))
    lower = ~upper
    others = [i for i in range(G) if i != k]
    for how, X in failures:
        with torch.no_grad():
            outs = tch._launch(X, inverse)
            outs = outs if inverse else (outs,)
        for name, o, g in zip(("L", "W"), outs, got):
            nan_at = lower if name == "L" else torch.ones_like(lower)
            if not (torch.equal(torch.isnan(o[k]), nan_at)
                    and bool((o[k][~nan_at] == 0).all())
                    and torch.equal(o[others], g[others])):
                raise AssertionError(f"{what}: the {how} matrix gave {name} "
                                     f"without its NaN, or touched the others")

    if kuu is None:
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        C = [torch.randn(A.shape, generator=gen, device=DEVICE) for _ in range(2)]

        def scalar(outs):
            outs = outs if inverse else (outs,)
            return sum(torch.sum(c.to(o.dtype) * o) for c, o in zip(C, outs))

        Ak = A.clone().requires_grad_(True)
        (gk,) = torch.autograd.grad(scalar(fn.apply(Ak)), Ak)
        Ad = A.double().requires_grad_(True)
        Ld = torch.linalg.cholesky(Ad)
        eye = torch.eye(Mi, dtype=torch.float64, device=DEVICE).expand(Ad.shape)
        ref = (Ld, torch.linalg.solve_triangular(Ld, eye, upper=False))
        (gd,) = torch.autograd.grad(scalar(ref if inverse else Ld), Ad)
        gerr = float((gk.double() - gd).abs().max()) / float(gd.abs().max())
        report.append(f"gradient {gerr:.2e} (tol {TOL_BWD})")
        if not gerr <= TOL_BWD:
            raise AssertionError(f"{what}: gradient off by {gerr:.2e} of scale")
    log(f"[kernels] {what}: err / max|plain f64|: {', '.join(report)}; repeat "
        f"and NaN above the diagonal bit-equal; "
        f"{' and '.join(how for how, _ in failures)} matrix NaN in place, ok")
    return worst


def largest_cholesky_m(inverse):
    """The largest M the plan of #7 (#8) takes, asked of its gate."""
    from dgp_tpu_torch.ops import cholesky as tch

    return max(m for m in range(1, 513) if tch.supported(m, inverse))


# -- phase 3 --------------------------------------------------------------------


def serving_model(white=True, seed=0, N_train=2_000):
    """benchmarks/predict_throughput.py's model, on the card, with the
    variational parameters of both layers perturbed (at the reference init,
    q_sqrt = I (whitened) or chol(Kuu) makes t2 == t1, so var == v and
    mean == 0 would hide any error in A or B)."""
    from dgp_tpu_torch.models.dgp import DGP
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N_train, DIN))
    Y = np.sin(3 * X[:, :1]) + 0.05 * rng.normal(size=(N_train, 1))
    Z = X[rng.choice(N_train, M, replace=False)].copy()
    f32 = dict(dtype=torch.float32, device=DEVICE)
    kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * DIN, **f32),
               K.RBF.create(variance=1.0, lengthscales=[1.0] * HIDDEN, **f32)]
    model = DGP(X, Y, Z, kernels, [HIDDEN], num_samples=S, white=white,
                device=DEVICE, dtype=torch.float32)
    perturb(model, rng)
    return model


def perturb(model, rng):
    """Move both layers' q off the prior: q_mu ~ N(0, 1); q_sqrt = tril(I +
    0.05 N) (whitened) or chol(Kuu) with each entry moved by 5 %. At the
    prior the ELBO does not depend on Z, so Z's gradient holds only
    rounding."""
    f32 = dict(dtype=torch.float32, device=DEVICE)
    with torch.no_grad():
        for layer in model.params.layers:
            Mi, D = layer.q_mu.shape
            layer.q_mu.copy_(torch.tensor(rng.normal(size=(Mi, D)), **f32))
            noise = torch.tensor(rng.normal(size=(D, Mi, Mi)), **f32)
            if layer.white:
                layer.q_sqrt.copy_(torch.tril(0.05 * noise) + torch.eye(Mi, **f32))
            else:
                layer.q_sqrt.mul_(1.0 + 0.05 * noise)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def counts():
    """Launch counts of kernels #1, #2 (the stationary fused conditional and
    its backward's phase A), #3, #4 (the Kuf-consuming fused conditional and
    its backward's phase A), #5, #6 (the quadform and its backward's phase
    A), #7 (the Cholesky factor), #8 (the factor with its inverse), and the
    phase B of #2, of #4 and of #6 (the split-K Grams)."""
    from dgp_tpu_torch.ops.cholesky import Cholesky, CholeskyInverse
    from dgp_tpu_torch.ops.conditional_fused import FusedConditionalWhite as FW
    from dgp_tpu_torch.ops.conditional_fused_rbf import FusedConditional as FC
    from dgp_tpu_torch.ops.quadform import QuadForm as QF

    return (FC.launches, FC.backward_launches, FW.launches,
            FW.backward_launches, QF.launches, QF.backward_launches,
            Cholesky.launches, CholeskyInverse.launches, FC.gram_launches,
            FW.gram_launches, QF.gram_launches)


def zero_counts():
    from dgp_tpu_torch.ops.cholesky import Cholesky, CholeskyInverse
    from dgp_tpu_torch.ops.conditional_fused import FusedConditionalWhite as FW
    from dgp_tpu_torch.ops.conditional_fused_rbf import FusedConditional as FC
    from dgp_tpu_torch.ops.quadform import QuadForm as QF

    FC.launches = FC.backward_launches = FC.gram_launches = 0
    FW.launches = FW.backward_launches = FW.gram_launches = 0
    QF.launches = QF.backward_launches = QF.gram_launches = 0
    Cholesky.launches = CholeskyInverse.launches = 0


COUNTED = "(#1, #2, #3, #4, #5, #6, #7, #8, #2B, #4B, #6B)"


def path_of(model):
    """Which kernels a model's conditionals run: "stationary" (whitened
    RBF: #1/#2), "composite" (whitened RBF + Linear: #3/#4) or "nonwhite"
    (#5/#6)."""
    layer = model.params.layers[0]
    if not layer.white:
        return "nonwhite"
    return "stationary" if type(layer.kernel).__name__ == "RBF" else "composite"


def expected_counts(path, evaluations, n_layers, loss=False):
    """counts() after `evaluations` predictions (or, with ``loss``, loss
    evaluations with their gradient) of a model of that path whose
    n_layers layers share one (M, white) group: each path runs its own pair
    of conditional kernels once per layer, and neither of the others';
    every evaluation factors its Kuu stack once through #8 (a non-whitened
    loss's KL takes that factor too), and none runs #7. A backward's phase
    B (#2B, #4B, #6B) runs once per phase A: every layer's points fit one
    pass."""
    pair = (evaluations * n_layers, evaluations * n_layers if loss else 0)
    zero = (0, 0)
    conditional = {"stationary": pair + zero + zero,
                   "composite": zero + pair + zero,
                   "nonwhite": zero + zero + pair}[path]
    grams = {"stationary": (pair[1], 0, 0), "composite": (0, pair[1], 0),
             "nonwhite": (0, 0, pair[1])}[path]
    return conditional + (0, evaluations) + grams


WHAT = {"stationary": "whitened", "composite": "RBF + Linear",
        "nonwhite": "non-whitened"}


def serve(model, gpu):
    """The main path: requests through the entry points a user calls; for
    the whitened model also one chunked request."""
    from dgp_tpu_torch.models.dgp import moment_matched, predict_y
    from dgp_tpu_torch.parallel.serving import predict_in_chunks

    rng = np.random.default_rng(1)
    requests = [rng.uniform(0, 1, size=(N_REQUEST, DIN)) for _ in range(3)]
    n_layers = len(model.params.layers)
    path = path_of(model)
    what = WHAT[path]

    zero_counts()
    for i, Xr in enumerate(requests):
        before = counts()
        (mean, var), dt = timed(lambda: model.predict_y(Xr, S))
        mm, mv = moment_matched(mean, var)
        launched = tuple(a - b for a, b in zip(counts(), before))
        if launched != expected_counts(path, 1, n_layers):
            raise AssertionError(f"request {i}: kernel launches {launched}, "
                                 f"expected {expected_counts(path, 1, n_layers)}")
        if mean.shape != (S, N_REQUEST, 1) or mm.shape != (N_REQUEST, 1):
            raise AssertionError(f"request {i}: shapes {tuple(mean.shape)}, {tuple(mm.shape)}")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()
                and (var > 0).all() and (mv > 0).all()):
            raise AssertionError(f"request {i}: non-finite or non-positive output")
        log(f"[serving] {what} request {i}: N={N_REQUEST} S={S}: "
            f"{1e3 * dt:.2f} ms, {N_REQUEST / dt:,.0f} points/s, kernel "
            f"launches {COUNTED} {launched} ({gpu})")
    if path != "stationary":
        return counts()

    X_big = rng.uniform(0, 1, size=(N_CHUNKED, DIN))
    before = counts()
    predict = lambda p, Xc, g: predict_y(p, Xc, S, g)
    with torch.no_grad():
        (cm, cv), dt = timed(lambda: predict_in_chunks(
            predict, model.params, X_big, model.generator, CHUNK,
            device=DEVICE))
    expect = expected_counts(path, N_CHUNKED // CHUNK, n_layers)
    launched = tuple(a - b for a, b in zip(counts(), before))
    if launched != expect:
        raise AssertionError(f"chunked: kernel launches {launched}, "
                             f"expected {expect}")
    if cm.shape != (S, N_CHUNKED, 1) or not (torch.isfinite(cm).all()
                                             and (cv > 0).all()):
        raise AssertionError("chunked request: bad output")
    log(f"[serving] chunked request: N={N_CHUNKED} in {CHUNK} chunks, S={S}: "
        f"{1e3 * dt:.2f} ms, {N_CHUNKED / dt:,.0f} points/s, kernel launches "
        f"{COUNTED} {launched} ({gpu})")
    return counts()


def request_inputs(model, seed=7):
    """Seeded request rows and the unit normals of every layer."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    X = torch.rand((N_REQUEST, DIN), generator=gen, device=DEVICE)
    zs = [torch.randn((S, N_REQUEST, l.num_outputs), generator=gen,
                      device=DEVICE) for l in model.params.layers]
    return X, zs


def compare_paths(model):
    """One request with the conditional kernels on and off, on the same
    unit normals, while the process asks for TF32 matrix products (as many
    training scripts do): the port's own products must stay IEEE fp32 all
    the same. Both arms factor Kuu through #8, so the comparison holds the
    conditional kernels alone; compare_factorizations holds #7/#8 against
    the library's factorization."""
    from dgp_tpu_torch.config import kernels_scope
    from dgp_tpu_torch.models.dgp import predict_y

    X, zs = request_inputs(model)
    torch.set_float32_matmul_precision("high")
    try:
        with torch.no_grad(), cholesky_route("kernels"):
            mk, vk = predict_y(model.params, X, S, zs=zs)
            with kernels_scope(False):
                mp, vp = predict_y(model.params, X, S, zs=zs)
    finally:
        torch.set_float32_matmul_precision("highest")
    em = float((mk - mp).abs().max()) / float(mp.abs().max())
    ev = float((vk - vp).abs().max()) / float(vp.abs().max())
    what = WHAT[path_of(model)]
    log(f"[serving] {what}: conditional kernels on vs off, one request, TF32 "
        f"asked for: mean err {em:.3e}, "
        f"var err {ev:.3e} of scale (tol {TOL_REQUEST})")
    if not (em <= TOL_REQUEST and ev <= TOL_REQUEST):
        raise AssertionError("the request differs with the kernels off")


def compare_factorizations(model, gradients=False):
    """One request (or, with ``gradients``, one loss and its gradients) on
    fixed unit normals with the Kuu factorizations through #7/#8 and through
    the library (cholesky_ex and solve_triangular), each against the same
    computation in float64 on the same inputs. Two float32 factorizations
    of the models' Kuu (max|Kuu^-1| in the thousands) differ by more than
    fp32 rounding, and a non-whitened mean carries Kuu^-1 q_mu, so neither
    arm is the other's reference: the kernels' arm is held to TOL_REQUEST
    of scale plus twice the library arm's own error, capped (hold_to_f64;
    the reference under f64_twin)."""
    import copy

    from dgp_tpu_torch.models.dgp import elbo, predict_y

    path = path_of(model)
    if gradients:
        gen = torch.Generator(device=DEVICE).manual_seed(9)
        zs = [torch.randn((S, N_TRAIN, l.num_outputs), generator=gen,
                          device=DEVICE) for l in model.params.layers]

        def evaluate(params, zs, dtype):
            X, Y = (t.to(dtype) for t in model.data)
            loss = -elbo(params, X, Y, S, zs=zs)
            return (loss.detach(), *torch.autograd.grad(
                loss, list(params.parameters())))

        names = ["loss"] + [n for n, _ in model.params.named_parameters()]
    else:
        X, zs = request_inputs(model, seed=8)

        @torch.no_grad()
        def evaluate(params, zs, dtype):
            return predict_y(params, X.to(dtype), S, zs=zs)

        names = ["mean", "var"]
    double = copy.deepcopy(model.params).double()
    with f64_twin():
        ref = evaluate(double, [z.double() for z in zs], torch.float64)
    arms = {}
    for route in ("kernels", "plain"):
        with cholesky_route(route):
            arms[route] = evaluate(model.params, zs, torch.float32)
    return hold_to_f64(f"[{'training' if gradients else 'serving'}] "
                       f"{WHAT[path]}: factorizations through #7/#8 vs the "
                       f"library", names, ref, arms["kernels"], arms["plain"])


def hold_to_f64(what, names, ref, kernels, library, cap=WITNESS_CAP):
    """Each output of the kernels' arm within TOL_REQUEST of its float64
    reference's scale plus twice the library arm's own error (the witness
    rule of the #3 checks), that second term capped at ``cap``
    (WITNESS_CAP unless a caller's state needs another); returns
    the largest error of the kernels' arm. The reference is the same
    function: computed under f64_twin, with the float32 jitter."""
    worst, report = 0.0, []
    for name, r, k, p in zip(names, ref, kernels, library):
        scale = float(r.abs().max()) or 1.0
        ek = float((k.double() - r).abs().max()) / scale
        ep = float((p.double() - r).abs().max()) / scale
        limit = TOL_REQUEST + min(2 * ep, cap)
        report.append(f"{name} {ek:.2e} (library {ep:.2e})")
        if not ek <= limit:
            raise AssertionError(f"{what}: {name} off float64 by {ek:.2e} of "
                                 f"scale, limit {limit:.2e}")
        worst = max(worst, ek)
    log(f"{what}, err / max|f64| (limit {TOL_REQUEST} + 2x the library's, "
        f"at most {cap}): {', '.join(report)}")
    return worst


@contextlib.contextmanager
def f64_twin():
    """Plain versions only, and the float32 jitter (1e-4) in every dtype: a
    float64 copy of a float32 model then computes the same function, not
    the better-conditioned one its own 1e-6 jitter would give."""
    from dgp_tpu_torch.config import default_jitter, jitter_scope, kernels_scope

    with kernels_scope(False), jitter_scope(default_jitter(torch.float32)):
        yield


# -- phase 4 --------------------------------------------------------------------


def training_model(white=True, seed=0, composite=False, mesh=None):
    """bench.py's model and data, built from the seed with numpy; the
    non-whitened model starts from the prior q_sqrt = chol(Kuu). With
    ``composite`` every layer's kernel is RBF + Linear (composite_kernel);
    with ``mesh`` it trains data-parallel on it."""
    from dgp_tpu_torch.models.dgp import DGP
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(N_TRAIN, DIN))
    Y = (np.sin(3 * X[:, :1]) + 0.5 * np.cos(5 * X[:, 1:2])
         + 0.05 * rng.normal(size=(N_TRAIN, 1)))
    Z = X[rng.choice(N_TRAIN, M, replace=False)].copy()
    f32 = dict(dtype=torch.float32, device=DEVICE)
    if composite:
        kernels = [composite_kernel(DIN), composite_kernel(HIDDEN)]
    else:
        kernels = [K.RBF.create(variance=1.0, lengthscales=[1.0] * DIN, **f32),
                   K.RBF.create(variance=1.0, lengthscales=[1.0] * HIDDEN, **f32)]
    return DGP(X, Y, Z, kernels, [HIDDEN], num_samples=S, white=white,
               mesh=mesh, device=DEVICE, dtype=torch.float32)


def train(model, gpu, adam_steps, nat_steps, masked_steps=0):
    """The training path through the entry points a user calls; returns the
    kernels' launch counts over it (counts())."""
    from dgp_tpu_torch.models import training

    path = path_of(model)
    what = WHAT[path]
    n_layers = len(model.params.layers)
    state = lambda: {k: v.clone() for k, v in model.params.state_dict().items()}
    start = state()
    zero_counts()

    losses, dt = timed(lambda: model.optimize_adam(iterations=adam_steps,
                                                   messages=0))
    losses = losses.cpu().numpy()
    if losses.shape != (adam_steps,) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"optimize_adam: bad losses {losses}")
    if not losses[-5:].mean() < losses[0]:
        raise AssertionError(f"optimize_adam: the loss did not fall: {losses}")
    evaluations = adam_steps
    expect = expected_counts(path, evaluations, n_layers, loss=True)
    if counts() != expect:
        raise AssertionError(f"optimize_adam: launches {counts()}, expected "
                             f"{expect}")
    log(f"[training] {what} optimize_adam {adam_steps} steps (first-use "
        f"warm-up included): {1e3 * dt:.1f} ms, loss {losses[0]:.1f} -> "
        f"{losses[-5:].mean():.1f} (mean of the last 5), launches "
        f"{COUNTED} {counts()} ({gpu})")

    n1, n2 = nat_steps
    losses, dt = timed(lambda: model.optimize_nat_adam(
        iterations1=n1, iterations2=n2, messages=0))
    losses = losses.cpu().numpy()
    if losses.shape != (n1 + n2,) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"optimize_nat_adam: bad losses {losses}")
    # one evaluation per Adam step, two per Adam+natural-gradient step
    evaluations += n1 + 2 * n2
    expect = expected_counts(path, evaluations, n_layers, loss=True)
    if counts() != expect:
        raise AssertionError(f"optimize_nat_adam: launches {counts()}, "
                             f"expected {expect}")
    log(f"[training] {what} optimize_nat_adam {n1} + {n2} steps: "
        f"{1e3 * dt:.1f} ms, loss {losses[0]:.1f} -> {losses[-1]:.1f}, "
        f"launches {counts()} ({gpu})")
    moved = state()
    if any(torch.equal(moved[k], start[k]) for k in start):
        raise AssertionError("a trained tensor did not move")
    if not masked_steps:
        return counts()

    # bench.py's model has no mean-function weights (Identity, then Zero),
    # so the frozen-tensor check freezes the hyperparameters instead
    mask = training.make_mask(model.params,
                              frozen_fields=("kernel", "likelihood"))
    loss_fn, batch = model._loss_spec()
    training.adam_run(loss_fn, model.params, mask, model.generator,
                      steps=masked_steps, data=batch)
    evaluations += masked_steps
    after = state()
    frozen = [k for k in after if not mask[k]]
    if (len(frozen) != 5 or counts() != expected_counts(
            path, evaluations, n_layers, loss=True)):
        raise AssertionError(f"masked phase: frozen {frozen}, launches {counts()}")
    for k in after:
        if torch.equal(after[k], moved[k]) != (k in frozen):
            raise AssertionError(f"masked phase: {k} "
                                 f"{'moved' if k in frozen else 'did not move'}")
    log(f"[training] {masked_steps} Adam steps with {len(frozen)} frozen "
        f"tensors: frozen bit for bit unchanged, the rest moved; launches on "
        f"the training path {COUNTED}: {counts()}")
    return counts()


def compare_gradients(model):
    """One loss-and-gradient evaluation on fixed unit normals, conditional
    kernels on against off (both arms factor Kuu through #7/#8, as in
    compare_paths). The model's q must be off the prior (perturb), or
    Z's gradient is rounding; after a few natural-gradient steps the last
    layer's q_sqrt is small and t2 barely reaches the loss."""
    from dgp_tpu_torch.config import kernels_scope
    from dgp_tpu_torch.models.dgp import elbo

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    zs = [torch.randn((S, N_TRAIN, l.num_outputs), generator=gen, device=DEVICE)
          for l in model.params.layers]
    params = dict(model.params.named_parameters())

    def evaluate():
        loss = -elbo(model.params, *model.data, S, zs=zs)
        return loss.detach(), torch.autograd.grad(loss, list(params.values()))

    path = path_of(model)
    n_layers = len(model.params.layers)
    before = counts()
    with cholesky_route("kernels"):
        loss_on, on = evaluate()
        launched = tuple(a - b for a, b in zip(counts(), before))
        with kernels_scope(False):
            loss_off, off = evaluate()
    expect = expected_counts(path, 1, n_layers, loss=True)
    # the off arm launches #7 and #8 only
    off_arm = (0,) * 6 + expect[6:8] + (0, 0, 0)
    if launched != expect or counts() != tuple(
            b + e + o for b, e, o in zip(before, expect, off_arm)):
        raise AssertionError(f"gradient evaluation launched {launched}")
    worst = abs(float(loss_on - loss_off)) / abs(float(loss_off))
    report = [f"loss {worst:.2e}"]
    for name, a, b in zip(params, on, off):
        err = float((a - b).abs().max()) / float(b.abs().max())
        report.append(f"{name} {err:.2e}")
        worst = max(worst, err)
    log(f"[training] {WHAT[path]}: kernels on vs off, loss and gradients on fixed "
        f"normals, err / max|off| (tol {TOL_GRAD}): {', '.join(report)}")
    if not worst <= TOL_GRAD:
        raise AssertionError("the gradients differ with the kernels off")


# -- phase 5: single-objective BO ------------------------------------------------


class BOProblem:
    """compat/validate_bo.py's problem (nb_dgp_BO): min (x - 0.5)^2 subject
    to step(x - 0.25) <= 0, x in [0, 1]; the optimum is 0.0625 at x = 0.25."""

    constraint = True
    dim = 1

    def fun(self, x):
        return [(x - 0.5) ** 2, np.where(x > 0.25, 1.0, 0.0)]


BO_SPEC_Y = {"num_layers": 0, "kernels": "rbf"}
BO_SPEC_C = {"num_layers": 2, "num_units": 1, "kernels": "rbf",
             "num_samples": 10}
BO_DOE, BO_SEED = 5, 7        # validate_bo.py's DoE and seed
# cuts of validate_bo.py --dgp, one each: 13 infills, 4000 training
# iterations, DE 300 x 400 and 1000 Adam steps
BO_INFILLS = 2
BO_TRAIN = 100
BO_DE = (60, 40)
BO_ADAM = 50
BO_DGP_ADAM = 500             # so_bo.train_model's fixed Adam phase, kept
# the constraint surrogate's quadform shapes (D, M, n): one output, M = 8
# (the padded DoE), n = 10 samples x 8 rows in training and 500 samples x
# the DE population in the acquisition
BO_QUADFORM = [(1, 8, 80), (1, 8, 500 * BO_DE[0])]
BO_RUN = dict(from_scratch=3, IC="EI", constraint_handling="EV",
              train_iterations=BO_TRAIN, popsize_DE=BO_DE[0], popstd_DE=3.0,
              iterations_DE=BO_DE[1], IC_method="DE+Adam",
              iterations_adam=BO_ADAM, verbose=False)


def bo_expected_counts():
    """counts() after the BO loop, reckoned from its structure. Building
    SO_BO builds the DGP constraint surrogate: num_layers = 2 makes three
    non-whitened SVGP layers, all of M = 8 (the padded DoE), each of whose
    initial q_sqrt = chol(Kuu) is one #7. Infill j then trains both
    surrogates for T = BO_TRAIN steps (BO_TRAIN // 2 after the first): the
    GPR's T Adam steps factor its Gram once each (#7); the DGP's
    BO_DGP_ADAM Adam steps and T Adam + natural-gradient steps (two loss
    evaluations each) factor its one (M, white) Kuu group once per
    evaluation (#8, whose factor the KL takes too) and run each layer's
    quadform and its backward (#5, #6, whose phase B (#6B) runs once per
    backward: every n here fits one pass). The acquisition evaluates EV (the
    DGP, 500 samples: #8 once, #5 per layer) and EI (the GPR's Gram: #7)
    once for DE's first population, once per generation, once per Adam step
    (with the quadform's backward, #6) and once more at Adam's final
    point."""
    layers = BO_SPEC_C["num_layers"] + 1
    c5 = c6 = c8 = 0
    c7 = layers
    for j in range(BO_INFILLS):
        T = BO_TRAIN if j == 0 else BO_TRAIN // 2
        loss_evals = BO_DGP_ADAM + 2 * T
        acq_evals = (1 + BO_DE[1]) + (BO_ADAM + 1)
        c5 += layers * (loss_evals + acq_evals)
        c6 += layers * (loss_evals + BO_ADAM)
        c7 += T + acq_evals
        c8 += loss_evals + acq_evals
    return (0, 0, 0, 0, c5, c6, c7, c8, 0, 0, c6)


def run_bo(gpu):
    """The BO path through the entry points a user calls: SO_BO on the
    card with a GPR objective surrogate and a DGP constraint surrogate
    (num_layers = 2: three non-whitened SVGP layers), EI with EV handling,
    DE + Adam, BO_INFILLS infills. Checks the Ymin trace (finite,
    non-increasing, at or above the optimum) and the launches of #5-#8
    against bo_expected_counts(); then the final surrogates' predictions
    (the DGP's on fixed unit normals) with every kernel on and with the
    plain versions, each against the same prediction in float64
    (hold_to_f64). Returns counts()."""
    import copy

    from dgp_tpu_torch.bo.so_bo import SO_BO
    from dgp_tpu_torch.config import kernels_scope
    from dgp_tpu_torch.models import dgp as tdgp
    from dgp_tpu_torch.models import gpr as tgpr

    zero_counts()
    bo, dt = timed(lambda: SO_BO(problem=BOProblem(), DoE_size=BO_DOE,
                                 model_Y_dic=BO_SPEC_Y, model_C_dic=BO_SPEC_C,
                                 seed=BO_SEED, device=DEVICE))
    log(f"[bo] SO_BO built on {DEVICE} in {dt:.2f} s: DoE {BO_DOE}, seed "
        f"{BO_SEED}, Ymin {bo.Ymin[-1]:.5f}; cut from validate_bo.py --dgp: "
        f"infills 13 -> {BO_INFILLS}, train_iterations 4000 -> {BO_TRAIN} "
        f"(the fixed {BO_DGP_ADAM}-step Adam phase kept), DE 300x400 -> "
        f"{BO_DE[0]}x{BO_DE[1]}, Adam 1000 -> {BO_ADAM}")
    training_s = []
    train_models = bo.train_models

    def timed_training(*args, **kwargs):
        out, dt = timed(lambda: train_models(*args, **kwargs))
        training_s.append(dt)
        return out

    bo.train_models = timed_training
    for j in range(BO_INFILLS):
        _, dt = timed(lambda: bo.run(1, **BO_RUN))
        log(f"[bo] infill {j}: {dt:.2f} s, of which surrogate training "
            f"{training_s[-1]:.2f} s and acquisition {dt - training_s[-1]:.2f} "
            f"s; new x {bo.X[-1, 0]:.5f}, Ymin {bo.Ymin[-1]:.5f} ({gpu})")
    launched, expect = counts(), bo_expected_counts()
    ymin = np.asarray(bo.Ymin, dtype=float)
    log(f"[bo] Ymin trace {np.array2string(ymin, precision=5)}; launches "
        f"{COUNTED} {launched}, reckoned {expect}")
    if not (ymin.shape == (BO_INFILLS + 1,) and np.all(np.isfinite(ymin))
            and np.all(np.diff(ymin) <= 0) and ymin[-1] >= 0.0625 - 1e-9):
        raise AssertionError(f"BO: bad Ymin trace {ymin}")
    if launched != expect or min(*launched[4:8], launched[10]) < 1:
        raise AssertionError(f"BO: launches {launched}, reckoned {expect}")

    x = torch.linspace(bo.lw_n[0], bo.up_n[0], 101, device=DEVICE)[:, None]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    zs = [torch.randn((500, 101, 1), generator=gen, device=DEVICE)
          for _ in range(BO_SPEC_C["num_layers"] + 1)]
    gpr, dgp = bo.model_Y, bo.model_C[0]

    @torch.no_grad()
    def predict(gpr_params, data, dgp_params, dtype):
        return (*tgpr.predict_y(gpr_params, data, x.to(dtype)),
                *tdgp.predict_y(dgp_params, x.to(dtype), 500,
                                zs=[z.to(dtype) for z in zs]))

    with f64_twin():
        ref = predict(copy.deepcopy(gpr.params).double(),
                      tuple(t.double() for t in gpr.train_data),
                      copy.deepcopy(dgp.params).double(), torch.float64)
    with kernels_scope(False):
        plain = predict(gpr.params, gpr.train_data, dgp.params, torch.float32)
    kernels = predict(gpr.params, gpr.train_data, dgp.params, torch.float32)
    hold_to_f64("[bo] final surrogates, every kernel vs the plain versions",
                ["GPR mean", "GPR var", "DGP mean", "DGP var"], ref, kernels,
                plain)
    return launched


# -- phase 6: the multi-fidelity deep GP ----------------------------------------


def mf_model(seed=0, mesh=None):
    """The Park configuration (MF_*) as a MultiFidelityDeepGP on the card
    in float32, its data from the port's own lhs and test functions (on
    ``mesh`` where given)."""
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.models.mf_dgp import MultiFidelityDeepGP
    from dgp_tpu_torch.utils.test_functions import park_high, park_low

    X = [lhs(MF_DIN, MF_N[0], seed=123), lhs(MF_DIN, MF_N[1], seed=124)]
    Y = [park_low(X[0]), park_high(X[1])]
    return MultiFidelityDeepGP(X, Y, num_samples=MF_S, seed=seed, mesh=mesh,
                               device=DEVICE, dtype=torch.float32)


def mf_request_rows():
    from dgp_tpu_torch.bo.doe import lhs

    return lhs(MF_DIN, MF_REQUEST, seed=125)


def kuu_twins(layers, zs):
    """(A, A64): the float32 Kuu stack of ``layers`` at the inducing inputs
    ``zs`` (each kernel's White inside, the float32 jitter 1e-4) and its
    float64 twin: the same kernels in float64 at the same inducing inputs,
    under the same jitter (f64_twin)."""
    import copy

    from dgp_tpu_torch.ops.conditionals import _jittered_kuu

    with torch.no_grad():
        A = torch.stack([_jittered_kuu(layer.kernel, z, None)
                         for layer, z in zip(layers, zs)])
        with f64_twin():
            A64 = torch.stack([
                _jittered_kuu(copy.deepcopy(layer.kernel).double(), z.double(),
                              None)
                for layer, z in zip(layers, zs)])
    return A, A64


def park_kuu():
    """[(name, (A, A64))]: the Park model's own Kuu stacks, [1, 30, 30]
    (layer 0 at Z) and [1, 5, 5] (layer 1 at its augmented Z, recomputed),
    each with its float64 twin (kuu_twins)."""
    from dgp_tpu_torch.models.mf_dgp import compute_full_zs

    model = mf_model()
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with torch.no_grad():
        zs = compute_full_zs(model.params.layers, gen)
    return [(f"Park layer {i}", kuu_twins([layer], [z]))
            for i, (layer, z) in enumerate(zip(model.params.layers, zs))]


def mf_expected_counts(built=0, losses=0, requests=0):
    """counts() reckoned for the two-fidelity Park model (layer 0 of M = 30,
    layer 1 of M = 5, both non-whitened). Building it: #7 per layer (the
    initial q_sqrt), and init_layers_mf's Z_right (layer 0 at 100 x 5
    points: #8 for its projection, #5). A loss evaluation with its
    gradient: compute_full_zs's Z_right (layer 0 at 50 x 5 points: #8, #5),
    the layers' projections (#8 per (M, white) group: two, whose Lu the
    KLs take too), the fidelity-0 term (layer 0: #5) and the fidelity-1
    term (layers 0 and 1: #5 each); the backward runs #6 and its phase B
    once per #5 (every n fits one pass). A request: the same Z_right, the
    two #8 and one #5 per layer."""
    c5 = built + 4 * losses + 3 * requests
    c6 = 4 * losses
    c8 = built + 3 * losses + 3 * requests
    return (0, 0, 0, 0, c5, c6, 2 * built, c8, 0, 0, c6)


@contextlib.contextmanager
def phase_snapshots():
    """Record (loop, mask, parameters before, after) of every training
    phase run inside the scope (adam_run and nat_adam_run wrapped)."""
    from dgp_tpu_torch.models import training

    seen = []
    saved = training.adam_run, training.nat_adam_run

    def wrap(loop, run):
        def wrapped(loss_fn, params, mask, *args, **kwargs):
            state = lambda: {k: v.clone()
                             for k, v in params.state_dict().items()}
            before = state()
            out = run(loss_fn, params, mask, *args, **kwargs)
            seen.append((loop, mask, before, state()))
            return out
        return wrapped

    training.adam_run = wrap("Adam", saved[0])
    training.nat_adam_run = wrap("Adam + natural gradients", saved[1])
    try:
        yield seen
    finally:
        training.adam_run, training.nat_adam_run = saved


MF_MOVES = {"z_left": 2, "z": 2, "likelihood": 3, "q_mu": 3, "q_sqrt": 3}


def mf_moves(name, nat):
    """The phase from which the MF model's tensor ``name`` moves: z and
    z_left from phase 2, the likelihood and q in phase 3; None for the
    tensors not checked (the kernels)."""
    parts = name.split(".")
    return next((MF_MOVES[f] for f in MF_MOVES if f in parts), None)


def check_mf_training(what, seen, losses, nat, window=10, moves=mf_moves,
                      tag="mf", moved="z_left moved from phase 2, the "
                      "likelihood and q in phase 3"):
    """The three phases ran as the reference stages them: with the MF
    model (``moves`` = mf_moves), phase 1 trains the kernels alone (z,
    z_left, the likelihood and every q frozen), phase 2 also the inducing
    inputs, phase 3 everything but q (which the natural gradient moves)
    or, with Adam, everything. Each frozen tensor is unchanged bit for bit
    (q aside in the natural-gradient phase), and each tensor that
    ``moves(name, nat)`` names a phase for stays unchanged before that
    phase and moves from it on (math.inf: never). The losses are finite and
    the last ``window`` below the first ``window`` (means)."""
    losses = losses.cpu().numpy()
    first, last = losses[:window].mean(), losses[-window:].mean()
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"[{tag}] {what}: losses {losses}")
    loops = [loop for loop, *_ in seen]
    if loops != ["Adam", "Adam", "Adam + natural gradients" if nat else "Adam"]:
        raise AssertionError(f"[{tag}] {what}: phases {loops}")
    report = []
    for phase, (loop, mask, before, after) in enumerate(seen, 1):
        frozen = sorted(k for k, trained in mask.items() if not trained)
        for name in mask:
            from_phase = moves(name, nat)
            unchanged = torch.equal(before[name], after[name])
            q = name.split(".")[-1] in ("q_mu", "q_sqrt")
            if name in frozen and not unchanged and not (loop != "Adam" and q):
                raise AssertionError(f"[{tag}] {what}: frozen {name} moved in "
                                     f"phase {phase}")
            if from_phase is not None and unchanged != (phase < from_phase):
                raise AssertionError(f"[{tag}] {what}: {name} "
                                     f"{'did not move' if unchanged else 'moved'}"
                                     f" in phase {phase}")
        report.append(f"phase {phase} ({loop}) {len(frozen)} frozen")
    log(f"[{tag}] {what}: losses finite, {first:.1f} -> {last:.1f} (means of "
        f"the first and last {window}); "
        f"{', '.join(report)}: frozen tensors bit for bit unchanged, {moved}")


def run_staged(tag, build, nat_steps, adam_steps, rows, expected, describe,
               gpu, lr_adam, nat_options=None, **check):
    """A multi-fidelity (or multi-objective) path through the entry points
    a user calls: build the model, optimize_nat_adam(lr_adam,
    **nat_options) for ``nat_steps``, a fresh model's optimize_adam for
    ``adam_steps``, then one predict of ``rows`` at 250 samples
    (moment-matched). Checks each phase's frozen tensors and the losses
    (check_mf_training), the prediction's shapes and finiteness, and the
    launches of #5-#8 against ``expected(built=, losses=, requests=)``;
    ``check`` goes to check_mf_training. Returns (counts(), the trained
    model)."""
    zero_counts()
    model, dt_build = timed(build)
    n1, n2, n3 = nat_steps
    with phase_snapshots() as seen:
        losses, dt_nat = timed(lambda: model.optimize_nat_adam(
            lr_adam=lr_adam, iterations1=n1, iterations2=n2, iterations3=n3,
            messages=0, **(nat_options or {})))
    check_mf_training(f"optimize_nat_adam {n1} + {n2} + {n3} steps", seen,
                      losses, nat=True, tag=tag, **check)
    fresh = build(seed=1)
    a1, a2, a3 = adam_steps
    with phase_snapshots() as seen:
        losses, dt_adam = timed(lambda: fresh.optimize_adam(
            iterations1=a1, iterations2=a2, iterations3=a3, messages=0))
    check_mf_training(f"optimize_adam {a1} + {a2} + {a3} steps", seen,
                      losses, nat=False, tag=tag, **check)
    (mean, var), dt_predict = timed(lambda: model.predict(rows))
    if not (mean.shape == var.shape == (len(rows), 1)
            and np.all(np.isfinite(mean)) and np.all(var > 0)):
        raise AssertionError(f"[{tag}] predict: bad output")
    launched = counts()
    expect = expected(built=2, losses=n1 + n2 + 2 * n3 + a1 + a2 + a3,
                      requests=1)
    log(f"[{tag}] {describe}: built in {dt_build:.2f} s; optimize_nat_adam "
        f"{dt_nat:.2f} s; optimize_adam {dt_adam:.2f} s; predict of "
        f"{len(rows)} rows at 250 samples {1e3 * dt_predict:.1f} ms (first "
        f"use); launches {COUNTED} {launched}, reckoned {expect} ({gpu})")
    if launched != expect:
        raise AssertionError(f"[{tag}] launches {launched}, reckoned {expect}")
    return launched, model


def run_mf(gpu):
    """The multi-fidelity path (run_staged): the Park model,
    optimize_nat_adam(lr_adam=0.005) for MF_NAT steps, optimize_adam for
    MF_ADAM, a predict of MF_REQUEST rows; launches as mf_expected_counts
    reckons them."""
    return run_staged(
        "mf", mf_model, MF_NAT, MF_ADAM, mf_request_rows(), mf_expected_counts,
        f"Park (Din {MF_DIN}, N {MF_N}, M = N, S {MF_S}, float32)", gpu,
        lr_adam=0.005)


def mf_normals(model, gen, rows=None, S=MF_S):
    """Fixed unit normals in the order the MF functions draw them: each
    augmented layer's Z_right (one [50, M_i, D] draw per earlier layer),
    then one [S, rows, D] per layer for a request of ``rows`` rows or, with
    ``rows`` None, one [S, N_f, D] per layer up to f for each fidelity f of
    a loss."""
    layers = model.params.layers
    shapes = [(50, layers[i].z_left.shape[0], layers[j].num_outputs)
              for i in range(1, len(layers)) for j in range(i)]
    if rows is None:
        shapes += [(S, x.shape[0], layers[i].num_outputs)
                   for f, x in enumerate(model._X) for i in range(f + 1)]
    else:
        shapes += [(S, rows, layer.num_outputs) for layer in layers]
    return [torch.randn(shape, generator=gen, device=DEVICE)
            for shape in shapes]


def compare_on_off(tag, model, rows, predict, elbo, expect_request,
                   expect_loss, nonzero, gradient_witness=False, vector=False):
    """One request of ``rows`` (``predict(params, X, dtype)``, then
    moment-matched) and one loss (-``elbo(params, dtype)``) with its
    gradients, on the fixed unit normals the two closures hold: the
    conditional kernels (the quadform's, or #1-#4 on whitened layers) on
    against off (both arms factor Kuu through #7/#8, as
    compare_paths) within TOL_REQUEST / TOL_GRAD of scale, the launches of
    the kernels' arm as ``expect_request`` / ``expect_loss``, the gradients
    of ``nonzero`` nonzero and finite; then the request with every kernel
    on against the plain versions (use_kernels off, #7/#8 too) within
    TOL_REQUEST of scale, and each of the two against the same request in
    float64 (f64_twin, hold_to_f64). With ``gradient_witness``, where the
    float32 loss gradient is itself ill-conditioned, each gradient of the
    kernels' arm is held to the plain arm's within TOL_GRAD plus twice the
    plain arm's own distance from the float64 twin's, that second term
    capped at WITNESS_CAP (the witness rule of hold_to_f64). With
    ``vector`` (a trained model, some of whose gradients vanish while the
    terms they sum do not), every gradient is held as one vector, as
    compare_exact holds one: each error, and each witness, is taken against
    the largest |gradient| of all the parameters (the loss against its
    own)."""
    import copy

    from dgp_tpu_torch.config import ieee_fp32, kernels_scope
    from dgp_tpu_torch.models.dgp import moment_matched

    X = torch.tensor(rows, dtype=torch.float32, device=DEVICE)
    names = [n for n, _ in model.params.named_parameters()]

    @torch.no_grad()
    def request(params, dtype):
        return moment_matched(*predict(params, X.to(dtype), dtype))

    def loss_and_grads(params, dtype):
        with ieee_fp32():
            loss = -elbo(params, dtype)
            return (loss.detach(), *torch.autograd.grad(
                loss, list(params.parameters())))

    for what, fn, labels, tol, expect in (
            ("request", request, ["mean", "var"], TOL_REQUEST, expect_request),
            ("loss and gradients", loss_and_grads, ["loss"] + names, TOL_GRAD,
             expect_loss)):
        before = counts()
        with cholesky_route("kernels"):
            on = fn(model.params, torch.float32)
            launched = tuple(a - b for a, b in zip(counts(), before))
            with kernels_scope(False):
                off = fn(model.params, torch.float32)
        if launched != expect:
            raise AssertionError(f"[{tag}] {what}: launches {launched}, "
                                 f"expected {expect}")
        witness = what != "request" and gradient_witness

        def scales(outs):
            s = [float(o.abs().max()) or 1.0 for o in outs]
            if vector and what != "request":
                s[1:] = [max(s[1:])] * (len(s) - 1)
            return s

        limits = [tol] * len(labels)
        if witness:
            double = copy.deepcopy(model.params).double()
            with f64_twin():
                ref = fn(double, torch.float64)
            limits = [tol + min(2 * float((b.double() - r).abs().max()) / sr,
                                WITNESS_CAP)
                      for b, r, sr in zip(off, ref, scales(ref))]
        report = []
        for name, a, b, limit, sb in zip(labels, on, off, limits, scales(off)):
            err = float((a - b).abs().max()) / sb
            report.append(f"{name} {err:.2e}"
                          + (f" (limit {limit:.2e})" if witness else ""))
            if not err <= limit:
                raise AssertionError(f"[{tag}] {what}: {name} differs with the "
                                     f"conditional kernels off by {err:.2e}, "
                                     f"limit {limit:.2e}")
        log(f"[{tag}] {what}: conditional kernels on vs off on fixed normals, "
            f"err / max|off|{' of all gradients' if vector and witness else ''} "
            f"(tol {tol}"
            + (f" + 2x off's own error against float64, at most "
               f"{WITNESS_CAP}" if witness else "")
            + f"): {', '.join(report)}")
        if what != "request":
            for name in nonzero:
                g = on[1 + names.index(name)]
                if not (torch.isfinite(g).all() and bool((g != 0).any())):
                    raise AssertionError(f"[{tag}] {name}'s gradient {g}")
            continue
        double = copy.deepcopy(model.params).double()
        with f64_twin():
            ref = fn(double, torch.float64)
        with kernels_scope(False):
            plain = fn(model.params, torch.float32)
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(on, plain)]
        log(f"[{tag}] {what}: every kernel on vs off (use_kernels), err / "
            f"max|off| (tol {TOL_REQUEST}): "
            + ", ".join(f"{n} {e:.2e}" for n, e in zip(labels, errs)))
        if not max(errs) <= TOL_REQUEST:
            raise AssertionError(f"[{tag}] {what}: differs with use_kernels "
                                 f"off")
        hold_to_f64(f"[{tag}] {what}: every kernel vs the plain versions",
                    labels, ref, on, plain)


def compare_mf(model):
    """compare_on_off for the Park model: a 1,000-row request at 250
    samples and a loss, z_left's gradient nonzero. (The float32 loss
    gradient is itself off its float64 twin by more than WITNESS_CAP at
    this Kuu, in layer 0's z: a CPU rehearsal with the plain versions in
    both arms.)"""
    from dgp_tpu_torch.models import mf_dgp as tmf

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    zr = mf_normals(model, gen, rows=MF_REQUEST, S=MF_PREDICT_S)
    zl = mf_normals(model, gen)
    compare_on_off(
        "mf", model, mf_request_rows(),
        lambda params, X, dtype: tmf.predict_y(
            params, X, MF_PREDICT_S, noise=[z.to(dtype) for z in zr]),
        lambda params, dtype: tmf.elbo(
            params, [x.to(dtype) for x in model._X],
            [y.to(dtype) for y in model._Y], MF_S,
            noise=[z.to(dtype) for z in zl]),
        mf_expected_counts(requests=1), mf_expected_counts(losses=1),
        [f"layers.{i}.z_left" for i in range(1, len(model.params.layers))])


def time_staged(label, model, rows, gpu, steps=10, rounds=3, samples=250,
                predict=None):
    """Wall ms per loss-and-gradient evaluation of a model (host clock
    around ``steps`` evaluations, ``rounds`` rounds) and per predict of
    ``rows`` (``predict``, by default the multi-fidelity models'
    ``model.predict(rows)`` at 250 samples); the device's idle share over
    three Adam steps (torch.profiler)."""
    predict = predict or (lambda: model.predict(rows))
    from dgp_tpu_torch.config import ieee_fp32
    from dgp_tpu_torch.models import training

    loss_fn, batch = model._loss_spec()
    params = list(model.params.parameters())

    def evaluations():
        with ieee_fp32():
            for _ in range(steps):
                loss = loss_fn(model.params, model.generator, batch)
                torch.autograd.grad(loss, params)

    evaluations()
    ms = [1e3 * timed(evaluations)[1] / steps for _ in range(rounds)]
    log(f"[timing] {label} loss and gradient, ms per evaluation over "
        f"{steps}, {rounds} rounds: {', '.join(f'{t:.2f}' for t in ms)} "
        f"({gpu})")
    name = label.split(" ")[0]
    predict()
    ms = [1e3 * timed(predict)[1] for _ in range(rounds)]
    log(f"[timing] {name} predict, {len(rows)} rows at {samples} samples "
        f"(moment-matched, to the host), ms per request, {rounds} rounds: "
        f"{', '.join(f'{t:.2f}' for t in ms)} ({gpu})")
    mask = training.make_mask(model.params)
    profile_run(f"three {name} Adam steps", lambda: training.adam_run(
        loss_fn, model.params, mask, model.generator, steps=3, data=batch),
        gpu)


def time_mf(model, gpu):
    time_staged(f"MF (Park, N {MF_N}, S {MF_S})", model, mf_request_rows(),
                gpu)


# -- phase 7: the multi-fidelity deep GP with Embedded Mapping ---------------------


def em_model(seed=0, mesh=None):
    """The Park_VD configuration (EM_*) as a MultiFidelityDeepGP_EM on the
    card in float32, its data from the port's own lhs and test functions
    (on ``mesh`` where given)."""
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.models.mf_dgp_em import MultiFidelityDeepGP_EM
    from dgp_tpu_torch.utils.test_functions import park_vd_high, park_vd_low

    X = [lhs(EM_DIN[0], EM_N[0], seed=123), lhs(EM_DIN[1], EM_N[1], seed=0)]
    Y = [park_vd_low(X[0]), park_vd_high(X[1])]
    return MultiFidelityDeepGP_EM(X, Y, [X[1][:, :EM_DIN[0]]],
                                  num_samples=EM_S, seed=seed, mesh=mesh,
                                  device=DEVICE, dtype=torch.float32)


def em_request_rows():
    from dgp_tpu_torch.bo.doe import lhs

    return lhs(EM_DIN[1], EM_REQUEST, seed=321)


def em_kuu():
    """[(name, (A, A64))]: the Park_VD model's own Kuu stacks, each with its
    float64 twin (kuu_twins): [1, 30, 30] (layer 0 at Z), [1, 6, 6] (the
    reduction layer at W, as each Z_right factors it) and [2, 6, 6] (layer
    1 at its augmented 5-D Z, recomputed, and the reduction layer: the
    stack a loss and a request factor)."""
    from dgp_tpu_torch.models.mf_dgp_em import compute_full_zs_em

    params = em_model().params
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with torch.no_grad():
        zs = compute_full_zs_em(params, gen)
    red = params.layers_red[0]
    return [("Park_VD layer 0", kuu_twins([params.layers[0]], [zs[0]])),
            ("Park_VD reduction layer", kuu_twins([red], [red.z])),
            ("Park_VD layer 1 and reduction layer",
             kuu_twins([params.layers[1], red], [zs[1], red.z]))]


def em_expected_counts(built=0, losses=0, requests=0):
    """counts() reckoned for the Park_VD model (reduction layer of D = 2,
    M = 6; layer 0 of M = 30; layer 1 of M = 6; all non-whitened).
    Building it: #7 per layer (the initial q_sqrt: three), and
    init_layers_mf_em's Z_right (the reduction layer, then layer 0, at
    100 x 6 points: #8 for each projection, #5 each). A loss evaluation
    with its gradient: compute_full_zs_em's Z_right (the same two at 50 x 6
    points: #8, #5 each), the projections of the three layers (#8 per
    (M, white) group: two, [1, 30, 30] and [2, 6, 6], whose Lu the KLs take
    too), the fidelity-0 term (layer 0: #5), the projection term (the
    reduction layer: #5; no Z_right) and the fidelity-1 term (the reduction
    layer, layers 0 and 1: #5 each); the backward runs #6 and its phase B
    once per #5 (every n fits one pass). A request: the same Z_right, the
    two #8 and one #5 per layer."""
    c5 = 2 * built + 7 * losses + 5 * requests
    c6 = 7 * losses
    c8 = 2 * built + 4 * losses + 4 * requests
    return (0, 0, 0, 0, c5, c6, 3 * built, c8, 0, 0, c6)


def em_moves(name, nat):
    """The phase from which the EM model's tensor ``name`` moves: the
    reduction layers' z from phase 1, z and z_left from phase 2, the
    fidelity layers' q in phase 3, the reduction layers' q_sqrt in the
    natural-gradient phase 3 only, the likelihood in Adam's phase 3 only,
    the projection likelihood never (math.inf); None for the kernels and
    for the reduction layers' q_mu, whose natural-gradient steps from this
    init (q_sqrt scaled 1e-5, S ~ 1e-10) are ~5e-12 of its size, below
    float32's resolution (a float64 CPU rehearsal)."""
    parts = name.split(".")
    red = parts[0] == "layers_red"
    if parts[0] == "likelihood_projection":
        return math.inf
    if parts[0] == "likelihood":
        return math.inf if nat else 3
    if parts[-1] in ("z", "z_left"):
        return 1 if red else 2
    if parts[-1] == "q_mu" and red:
        return None
    if parts[-1] in ("q_mu", "q_sqrt"):
        return 3 if nat or not red else math.inf
    return None


def run_em(gpu):
    """The Embedded Mapping path (run_staged): the Park_VD model,
    optimize_nat_adam(lr_adam=0.005) for EM_NAT steps, optimize_adam for EM_ADAM, a
    predict of EM_REQUEST rows; launches as em_expected_counts reckons
    them."""
    return run_staged(
        "em", em_model, EM_NAT, EM_ADAM, em_request_rows(), em_expected_counts,
        f"Park_VD (Din {EM_DIN}, N {EM_N}, Z = X, W = [X[1]], S {EM_S}, "
        f"float32)", gpu, lr_adam=0.005, moves=em_moves,
        moved="the reduction z moved from phase 1, z_left from phase 2, q in "
              "phase 3 (the reduction q_sqrt by the natural gradient only), the "
              "likelihood in Adam's phase 3 alone, the projection likelihood "
              "never")


def em_normals(model, gen, rows=None, S=EM_S):
    """Fixed unit normals in the order the EM functions draw them: each
    augmented layer i's Z_right (one [50, M_i, D] draw per reduction layer
    of its sub-chain, then per earlier layer), then for a request of
    ``rows`` rows one [S, rows, D] per reduction layer and per layer or,
    with ``rows`` None, for each fidelity f of a loss one [S, N_f, D] per
    reduction layer of layers_red[L-f:] and per layer up to f, and below the
    last fidelity one [S, N_{f+1}, D] per reduction layer of
    layers_red[L-f-1:] (the projection term)."""
    layers, reds = model.params.layers, model.params.layers_red
    L = len(reds)
    shapes = [(50, layers[i].z_left.shape[0], layer.num_outputs)
              for i in range(1, len(layers))
              for layer in (*reds[L - i:], *layers[:i])]
    if rows is None:
        for f, x in enumerate(model._X):
            shapes += [(S, x.shape[0], layer.num_outputs)
                       for layer in (*reds[L - f:], *layers[:f + 1])]
            if f < len(layers) - 1:
                shapes += [(S, model._X[f + 1].shape[0], layer.num_outputs)
                           for layer in reds[L - f - 1:]]
    else:
        shapes += [(S, rows, layer.num_outputs) for layer in (*reds, *layers)]
    return [torch.randn(shape, generator=gen, device=DEVICE)
            for shape in shapes]


def compare_em(model):
    """compare_on_off for the Park_VD model: a 1,000-row request at 250
    samples and a loss, the gradients of z_left, the reduction layer's z
    and q_mu and the projection likelihood nonzero. The float32 loss
    gradient here is itself off its float64 twin by up to 1.1e-1 of scale
    (layer 1's Linear variance; layer 0's z, q_mu and lengthscales ~5e-2;
    a CPU rehearsal after the phase's training, plain versions), and the
    two float32 arms differed by 2.5e-3 in layer 0's RBF variance (the
    card): the gradients are held by the witness rule
    (``gradient_witness``)."""
    from dgp_tpu_torch.models import mf_dgp_em as tem

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    zr = em_normals(model, gen, rows=EM_REQUEST, S=EM_PREDICT_S)
    zl = em_normals(model, gen)
    cast = lambda xs, dtype: [x.to(dtype) for x in xs]
    compare_on_off(
        "em", model, em_request_rows(),
        lambda params, X, dtype: tem.predict_y(
            params, X, EM_PREDICT_S, noise=cast(zr, dtype)),
        lambda params, dtype: tem.elbo(
            params, cast(model._X, dtype), cast(model._Y, dtype),
            cast(model._X_red, dtype), EM_S, noise=cast(zl, dtype)),
        em_expected_counts(requests=1), em_expected_counts(losses=1),
        ["layers.1.z_left", "layers_red.0.z", "layers_red.0.q_mu",
         "likelihood_projection.variance_raw"], gradient_witness=True)


def time_em(model, gpu):
    time_staged(f"EM (Park_VD, N {EM_N}, S {EM_S})", model, em_request_rows(),
                gpu)


# -- phase 8: the exact multi-fidelity surrogates ---------------------------------


def borehole_data():
    """The borehole pair as MF_BO builds it: each fidelity's DoE by lhs at
    seed 0 + f (dgp_tpu/bo/mf_bo.py:184), Y under one pooled normalization
    (:269-276)."""
    from dgp_tpu_torch.bo.doe import mf_doe
    from dgp_tpu_torch.utils.test_functions import borehole_high, borehole_low

    return mf_doe((borehole_low, borehole_high), XMF_D, XMF_DOE)[:2]


def nonlinear_data():
    """tests/test_nargp.py's pair: f_high = f_low^2, lhs seeds 0 and 1."""
    from dgp_tpu_torch.bo.doe import mf_doe
    from dgp_tpu_torch.utils.test_functions import (nonlinear_high,
                                                    nonlinear_low)

    return mf_doe((nonlinear_low, nonlinear_high), 1, NONLINEAR_DOE,
                  normalize=False)[:2]


def exact_model(kind, data, device=None):
    """An AR(1) co-kriging ("ar1") or NARGP ("nargp") surrogate on the card
    in float32, rows bucketed by XMF_BUCKET (NARGP predicting at XMF_S
    samples by default)."""
    from dgp_tpu_torch.models.cokriging import AR1CoKriging
    from dgp_tpu_torch.models.nargp import NARGP

    device = device or DEVICE
    if kind == "ar1":
        return AR1CoKriging(data, n_bucket=XMF_BUCKET, device=device,
                            dtype=torch.float32)
    return NARGP(data, n_bucket=XMF_BUCKET, num_samples=XMF_S, device=device,
                 dtype=torch.float32)


def exact_expected_counts(kind, iterations=0, requests=0, n_fid=2):
    """counts() reckoned for an exact surrogate: one #7 launch per engine
    step for all the starts at once, and one for each start's final loss
    (per level for NARGP, whose level t also factors each lower level's
    Gram once for its mean chain: one launch per level below it); one per
    request for AR(1)'s joint Gram, one per level for NARGP's."""
    if kind == "ar1":
        c7 = (iterations + 1 if iterations else 0) + requests
    else:
        c7 = (n_fid * (iterations + 1) + n_fid * (n_fid - 1) // 2
              if iterations else 0) + n_fid * requests
    return (0, 0, 0, 0, 0, 0, c7, 0, 0, 0, 0)


@contextlib.contextmanager
def engine_runs():
    """Record every training.multistart_adam run inside the scope: the
    number of starts, each start's final loss (the run's last loss
    evaluation), the winner's, its loss trace and the run's seconds."""
    from dgp_tpu_torch.models import training

    runs = []
    run = training.multistart_adam

    def recorded(loss_fn, stacked, batch, iterations, lr):
        last = []

        def loss(params, *args):
            out = loss_fn(params, *args)
            last[:] = [out.detach()]
            return out

        (best, nll, trace), dt = timed(
            lambda: run(loss, stacked, batch, iterations, lr))
        runs.append({"finals": last[0], "nll": float(nll), "trace": trace,
                     "seconds": dt, "iterations": iterations})
        return best, nll, trace

    training.multistart_adam = recorded
    try:
        yield runs
    finally:
        training.multistart_adam = run


def check_engine_runs(tag, runs, starts):
    """Each run: the winner's loss trace finite, its final loss the least
    finite final (non-finite finals counted as +inf) and no higher than
    start 0's."""
    for i, r in enumerate(runs):
        finals = torch.where(torch.isfinite(r["finals"]), r["finals"],
                             torch.inf).double().cpu()
        if not (finals.shape == (starts,)
                and bool(torch.isfinite(r["trace"]).all())
                and r["nll"] == float(finals.min())
                and r["nll"] <= float(finals[0])):
            raise AssertionError(f"[{tag}] engine run {i}: finals "
                                 f"{finals.tolist()}, winner {r['nll']}")


def train_exact(tag, kind, data, iterations, gpu):
    """optimize(XMF_STARTS starts, ``iterations`` steps, XMF_LR) of a fresh
    surrogate; the launches of #7 as exact_expected_counts reckons them and
    the engine runs as check_engine_runs. Returns (the trained model, its
    launches)."""
    zero_counts()
    model = exact_model(kind, data)
    with engine_runs() as runs:
        _, dt = timed(lambda: model.optimize(
            n_starts=XMF_STARTS, iterations=iterations, lr=XMF_LR, seed=0))
    check_engine_runs(tag, runs, XMF_STARTS)
    launched, expect = counts(), exact_expected_counts(kind, iterations)
    log(f"[exact_mf] {tag}: optimize({XMF_STARTS} starts x {iterations} "
        f"steps, lr {XMF_LR}) {dt:.2f} s, "
        + "; ".join(f"level {i}: {r['seconds']:.2f} s, "
                    f"{1e3 * r['seconds'] / r['iterations']:.3f} ms per engine "
                    f"step, final NLL {r['nll']:.4f} (start 0's "
                    f"{float(r['finals'][0]):.4f})"
                    for i, r in enumerate(runs))
        + f"; joint NLL {model._nll:.4f}; launches {COUNTED} {launched}, "
          f"reckoned {expect} ({gpu})")
    if launched != expect:
        raise AssertionError(f"[exact_mf] {tag}: launches {launched}, "
                             f"reckoned {expect}")
    return model, launched


def exact_loss(model):
    """(loss(params, dtype), params): the training loss of an exact
    surrogate on its train_data cast to ``dtype`` (AR(1)'s joint NLL, the
    sum of NARGP's level NLLs on its augmented rows)."""
    from dgp_tpu_torch.models import cokriging, gpr

    cast = lambda ts, dtype: tuple(None if t is None else t.to(dtype)
                                   for t in ts)
    data = model.train_data
    if model.name == "ar1":
        return lambda params, dtype: cokriging.neg_log_marginal_likelihood(
            params, *(cast(ts, dtype) for ts in data))
    return lambda params, dtype: sum(
        gpr.neg_log_marginal_likelihood(p, *cast(d, dtype))
        for p, d in zip(params, data))


def exact_grams_of(model, params, dtype):
    """[(K, y)]: the noise-augmented Gram of each factor an exact
    surrogate's training loss takes (AR(1)'s joint Gram, each NARGP level's)
    at ``params``, with its targets, on the train_data cast to ``dtype``."""
    from dgp_tpu_torch.models import cokriging, gpr

    cast = lambda ts: tuple(None if t is None else t.to(dtype) for t in ts)
    if model.name == "ar1":
        Xs, Ys, ws = (cast(ts) for ts in model.train_data)
        return [(cokriging._joint_gram(params, Xs, ws), torch.cat(Ys, dim=0))]
    return [(gpr._masked_gram(p, X, w), Y) for p, (X, Y, w) in
            zip(params, (cast(d) for d in model.train_data))]


def gradient_terms(model, params):
    """Per scalar parameter t (in the order of params.parameters()), the sum
    over the surrogate's Grams K of |G_ij| |dK_ij/dt|, G = (K^-1 - a a^T) / 2
    and a = K^-1 y: the magnitudes of the terms whose signed sum is the
    loss's gradient in t. At an optimum the terms cancel and the gradient
    vanishes while they do not, so this is the scale its error is held to
    there (as TOL_BWD holds dvariance, a sum that cancels, to the sum of its
    terms' magnitudes). Float64 ``params`` under f64_twin; dK by central
    differences."""
    with torch.no_grad():
        Gs = []
        for K, y in exact_grams_of(model, params, torch.float64):
            Ki = torch.cholesky_inverse(torch.linalg.cholesky(K))
            a = Ki @ y
            Gs.append((0.5 * (Ki - a @ a.T)).abs())
        out = []
        for p in params.parameters():
            flat = p.view(-1)
            for e in range(flat.numel()):
                old = float(flat[e])
                h = 1e-6 * max(1.0, abs(old))
                flat[e] = old + h
                up = exact_grams_of(model, params, torch.float64)
                flat[e] = old - h
                down = exact_grams_of(model, params, torch.float64)
                flat[e] = old
                out.append(sum(float((G * (u - d).abs()).sum()) / (2 * h)
                               for G, (u, _), (d, _) in zip(Gs, up, down)))
    return torch.tensor(out, dtype=torch.float64, device=DEVICE)


def compare_exact(tag, model, trained=False):
    """The training loss and its gradient (every parameter, as one vector)
    at the model's parameters: #7 on against the plain version (use_kernels
    off) within TOL_GRAD of scale plus twice the plain arm's own distance
    from the float64 twin's (the witness rule), one #7 launch per Gram; and
    each arm against the float64 twin, the kernels' arm within TOL_REQUEST
    plus twice the plain arm's distance (hold_to_f64's rule); the witness
    term at most WITNESS_CAP. The scale is the float64 twin's max|value|;
    with ``trained`` (the parameters at an optimum, where the gradient
    vanishes and its float32 error does not), each gradient entry's error is
    taken against its own gradient_terms instead."""
    import copy

    from dgp_tpu_torch.config import ieee_fp32, kernels_scope

    loss_fn = exact_loss(model)

    def loss_and_gradient(params, dtype):
        with ieee_fp32():
            loss = loss_fn(params, dtype)
            grads = torch.autograd.grad(loss, list(params.parameters()))
        return loss.detach(), torch.cat([g.reshape(-1) for g in grads])

    before = counts()
    on = loss_and_gradient(model.params, torch.float32)
    launched = counts()[6] - before[6]
    with kernels_scope(False):
        off = loss_and_gradient(model.params, torch.float32)
    with f64_twin():
        params64 = copy.deepcopy(model.params).double()
        ref = loss_and_gradient(params64, torch.float64)
        terms = gradient_terms(model, params64) if trained else None
    grams = 1 if model.name == "ar1" else len(model.params)
    if launched != grams:
        raise AssertionError(f"[exact_mf] {tag}: {launched} launches of #7, "
                             f"expected {grams}")
    report = []
    for name, a, b, r in zip(("NLL", "gradient"), on, off, ref):
        if name == "gradient" and trained:
            scale = torch.where(terms > 0, terms, torch.ones_like(terms))
        else:
            scale = float(r.abs().max()) or 1.0
        rel = lambda e: float((e.double().abs() / scale).max())
        err, own, ek = rel(a - b), rel(b.double() - r), rel(a.double() - r)
        witness = min(2 * own, WITNESS_CAP)
        limits = (TOL_GRAD + witness, TOL_REQUEST + witness)
        report.append(f"{name}: on vs off {err:.2e} (limit {limits[0]:.2e}), "
                      f"on vs float64 {ek:.2e} (limit {limits[1]:.2e}), off "
                      f"vs float64 {own:.2e}")
        if not (err <= limits[0] and ek <= limits[1]):
            raise AssertionError(f"[exact_mf] {tag}: {report[-1]}")
    log(f"[exact_mf] {tag}: loss and gradient, #7 on vs off and against the "
        f"float64 twin, err / "
        + ("max|reference| (the gradient's entries: / their gradient_terms)"
           if trained else "max|reference|")
        + f" (tol {TOL_GRAD} / {TOL_REQUEST} + 2x off's own error against "
          f"float64, at most {WITNESS_CAP}): " + "; ".join(report))


def exact_predictions(tag, model, rows, S, gpu):
    """predict_f and predict_y of ``rows``: shapes, finite values, variances
    not negative, #7's launches as reckoned; returns predict_f's moments
    (on the host) and the requests' launches."""
    zero_counts()
    X = np.asarray(rows, dtype=np.float32)
    kw = {} if model.name == "ar1" else {"S": S}
    (f_mean, f_var), ms_f = timed(lambda: model.predict_f(X, **kw))
    kw = {} if model.name == "ar1" else {"num_samples": S}
    (y_mean, y_var), ms_y = timed(lambda: model.predict_y(X, **kw))
    shape = (1 if model.name == "ar1" else S, len(rows), 1)
    for a in (f_mean, f_var, y_mean, y_var):
        if not (a.shape == shape and bool(torch.isfinite(a).all())):
            raise AssertionError(f"[exact_mf] {tag}: prediction of shape "
                                 f"{tuple(a.shape)} (expected {shape}) or "
                                 f"not finite")
    if not (bool((f_var >= 0).all()) and bool((y_var >= f_var).all())):
        raise AssertionError(f"[exact_mf] {tag}: variances")
    launched = counts()
    expect = exact_expected_counts(model.name, requests=2)
    log(f"[exact_mf] {tag}: predict_f and predict_y of {len(rows)} rows"
        + ("" if model.name == "ar1" else f" at {S} samples")
        + f": {1e3 * ms_f:.1f} / {1e3 * ms_y:.1f} ms (first use); launches "
          f"{COUNTED} {launched}, reckoned {expect} ({gpu})")
    if launched != expect:
        raise AssertionError(f"[exact_mf] {tag}: launches {launched}, "
                             f"reckoned {expect}")
    return f_mean.cpu().numpy(), f_var.cpu().numpy(), launched


def r2_nonlinear(model):
    """(held-out r2 of the moment-matched predict_f on the nonlinear pair,
    the request's launches)."""
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.models.dgp import moment_matched
    from dgp_tpu_torch.utils.test_functions import nonlinear_high

    Xt = lhs(1, NONLINEAR_TEST, seed=99)
    zero_counts()
    m_s, v_s = model.predict_f(Xt.astype(np.float32), S=NONLINEAR_S)
    launched = counts()
    mean, _ = moment_matched(m_s.double(), v_s.double())
    yt = nonlinear_high(Xt)
    r2 = 1.0 - float(np.mean((mean.cpu().numpy() - yt) ** 2) / np.var(yt))
    return r2, launched


def maximize_ei(tag, model, gpu):
    """One EI maximization over an exact surrogate by the port's DE + Adam,
    cut as the bo phase cuts it (DE BO_DE, BO_ADAM Adam steps) at XMF_S
    samples (NARGP), y_min the best normalized high-fidelity value: x in
    the box, -EI there finite and the reported objective; #7 launched once
    per Gram per evaluation ((1 + generations) + (Adam steps + 1)
    evaluations); for AR(1) the EI at x (exact moments) held to the same EI
    from the float64 twin's predict_f, the moments AR(1)'s EI takes
    (hold_to_f64, the plain versions' EI the witness). Returns the
    maximization's launches."""
    import copy

    from dgp_tpu_torch.bo import acquisition as acq
    from dgp_tpu_torch.config import kernels_scope
    from dgp_tpu_torch.models import cokriging

    y_min = float(model.data[1][-1].min())
    ei = acq.EI(y_min, XMF_D)
    bounds = (np.zeros(XMF_D), np.ones(XMF_D))
    zero_counts()
    x, dt = timed(lambda: ei.optimize(
        model, bounds, popsize_DE=BO_DE[0], iterations_DE=BO_DE[1],
        iterations_adam=BO_ADAM, method="DE+Adam", num_samples=XMF_S, key=0))
    evaluations = (1 + BO_DE[1]) + (BO_ADAM + 1)
    launched = counts()
    expect = exact_expected_counts(model.name, requests=evaluations)
    if not (x.shape == (1, XMF_D) and np.all((x >= 0) & (x <= 1))
            and np.isfinite(ei.IC_optimized) and launched == expect):
        raise AssertionError(f"[exact_mf] {tag} EI: x {x}, -EI "
                             f"{ei.IC_optimized}, launches {launched}, "
                             f"reckoned {expect}")
    log(f"[exact_mf] {tag}: EI maximized by DE {BO_DE[0]}x{BO_DE[1]} + "
        f"{BO_ADAM} Adam steps in {dt:.2f} s: EI {-ei.IC_optimized:.6g} "
        f"(y_min {y_min:.5f}); launches {COUNTED} {launched}, reckoned "
        f"{expect} ({gpu})")
    if model.name != "ar1":
        return launched
    key = acq.split_key(0)[1]
    with torch.no_grad():
        on = -ei.run(model, x, num_samples=XMF_S, key=key)
        with kernels_scope(False):
            plain = -ei.run(model, x, num_samples=XMF_S, key=key)
        with f64_twin():
            X64 = torch.tensor(x, dtype=torch.float64, device=DEVICE)
            data64 = tuple(tuple(t.double() for t in ts)
                           for ts in model.train_data)
            mean, var = cokriging.predict_f(
                copy.deepcopy(model.params).double(), data64, X64)
            ref = acq._expected_improvement(y_min, mean, var)
    if abs(float(on[0, 0]) + ei.IC_optimized) > 1e-6 * max(1.0, abs(
            ei.IC_optimized)):
        raise AssertionError(f"[exact_mf] {tag}: EI at x {float(on[0, 0])} "
                             f"is not the objective {-ei.IC_optimized}")
    hold_to_f64(f"[exact_mf] {tag}: EI at the maximizer, #7 vs the plain "
                f"version", ["EI"], [ref], [on], [plain])
    return launched


def ei_gradient(tag, model, gpu):
    """One EI loss and its gradient in x over a trained deep multi-fidelity
    surrogate (the mf or em phase's), at BO_DE[0] points and the acquisition's
    500 samples: finite, the gradient nonzero, the quadform kernels (#5,
    #6) and #8 launched. Returns the launches."""
    from dgp_tpu_torch.bo import acquisition as acq
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.config import ieee_fp32

    d = model._X[-1].shape[1]
    loss_fn, args = acq.EI(float(model._Y[-1].min()), d)._default_loss_spec(
        model, 0, num_samples=500)
    x = torch.tensor(lhs(d, BO_DE[0], seed=4), dtype=torch.float32,
                     device=DEVICE, requires_grad=True)
    zero_counts()
    with ieee_fp32():
        loss = loss_fn(x, args)
        (g,) = torch.autograd.grad(loss.sum(), x)
    launched = counts()
    if not (loss.shape == (BO_DE[0], 1) and bool(torch.isfinite(loss).all())
            and bool(torch.isfinite(g).all()) and bool((g != 0).any())
            and min(launched[4], launched[5], launched[7]) > 0):
        raise AssertionError(f"[exact_mf] {tag}: EI loss or gradient, "
                             f"launches {launched}")
    log(f"[exact_mf] {tag}: EI loss and gradient at {BO_DE[0]} points, 500 "
        f"samples: -EI in [{float(loss.detach().min()):.4g}, "
        f"{float(loss.detach().max()):.4g}], "
        f"max |grad| {float(g.abs().max()):.4g}; launches {COUNTED} "
        f"{launched} ({gpu})")
    return launched


def run_exact_mf(gpu, model_mf, model_em):
    """The exact multi-fidelity path through the entry points a user calls:
    AR(1) co-kriging and NARGP on the borehole pair (the loss and gradient
    at the init, train_exact at XMF_ITERATIONS, the loss and gradient at
    the trained parameters, 1,000-row predictions, an EI maximization
    each), the nonlinear pair's r2 oracle at its own budget, and the EI
    loss and gradient over the mf and em phases' models. Returns the
    path's launches (the comparisons' own left out)."""
    launches = []
    rows = np.random.default_rng(2).uniform(size=(XMF_REQUEST, XMF_D))
    data = borehole_data()
    for kind in ("ar1", "nargp"):
        tag = f"borehole {kind}"
        compare_exact(f"{tag} at the init", exact_model(kind, data))
        model, launched = train_exact(tag, kind, data, XMF_ITERATIONS, gpu)
        launches.append(launched)
        compare_exact(f"{tag} trained", model, trained=True)
        launches.append(exact_predictions(tag, model, rows, XMF_S, gpu)[2])
        launches.append(maximize_ei(tag, model, gpu))
    r2 = {}
    for kind in ("nargp", "ar1"):
        model, launched = train_exact(f"nonlinear {kind}", kind,
                                      nonlinear_data(), NONLINEAR_ITERATIONS,
                                      gpu)
        r2[kind], predicted = r2_nonlinear(model)
        launches += [launched, predicted]
    log(f"[exact_mf] nonlinear pair (f_high = f_low^2, N {NONLINEAR_DOE}): "
        f"held-out r2 on {NONLINEAR_TEST} points at {NONLINEAR_S} samples: "
        f"NARGP {r2['nargp']:.5f} (> 0.9), AR(1) {r2['ar1']:.5f} (< 0.5) "
        f"({gpu})")
    if not (r2["nargp"] > 0.9 and r2["ar1"] < 0.5):
        raise AssertionError(f"[exact_mf] nonlinear oracle: r2 {r2}")
    for tag, model in (("mf", model_mf), ("em", model_em)):
        launches.append(ei_gradient(tag, model, gpu))
    total = tuple(sum(c[k] for c in launches) for k in range(11))
    log(f"[exact_mf] launches on the path {COUNTED}: {total} ({gpu})")
    return total


def exact_grams():
    """[(name, (A, A64), witness)]: the Gram stacks the engine factors at
    its first step (its XMF_STARTS starts, seed 0), each with its float64
    twin under the float32 jitter: the borehole pair's AR(1) joint Gram
    [8, 56, 56] and NARGP level Grams [8, 40, 40] and [8, 16, 16] (level 1
    on the mean chain at the init), and the nonlinear pair's [8, 48, 48],
    [8, 32, 32] and [8, 16, 16]; padding rows with a unit diagonal and no
    coupling. ``witness`` is true for the nonlinear pair's stacks alone:
    their float32 entries move L off the twin's by more than TOL
    (check_cholesky's witness rule)."""
    import copy

    from dgp_tpu_torch.models import cokriging, gpr

    out = []
    for pair, data in (("borehole", borehole_data()),
                       ("nonlinear", nonlinear_data())):
        ar1 = exact_model("ar1", data)
        stacked = ar1._starts(XMF_STARTS, 0)
        Xs, _, ws = ar1.train_data
        with torch.no_grad():
            A = cokriging._joint_gram(stacked, Xs, ws)
            with f64_twin():
                A64 = cokriging._joint_gram(
                    copy.deepcopy(stacked).double(),
                    [x.double() for x in Xs], [w.double() for w in ws])
        witness = pair == "nonlinear"
        out.append((f"{pair} AR(1) joint Gram", (A, A64), witness))
        nargp = exact_model("nargp", data)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        for t, (X, _, w) in enumerate(nargp.train_data):
            stacked = nargp._starts(nargp.params[t], XMF_STARTS, gen)
            with torch.no_grad():
                A = gpr._masked_gram(stacked, X, w)
                with f64_twin():
                    A64 = gpr._masked_gram(copy.deepcopy(stacked).double(),
                                           X.double(), w.double())
            out.append((f"{pair} NARGP level {t} Gram", (A, A64), witness))
    return out


def time_engine(gpu, steps=50, rounds=3):
    """Wall ms per engine step (multistart_adam, XMF_STARTS starts) on the
    borehole pair's AR(1) joint NLL and NARGP's level-0 NLL, host clock
    around ``steps`` steps, ``rounds`` rounds; and the device's share of ten
    steps (profile_run)."""
    from dgp_tpu_torch.models import cokriging, gpr, training

    data = borehole_data()
    ar1, nargp = exact_model("ar1", data), exact_model("nargp", data)
    cases = {
        "AR(1) joint NLL [8, 56, 56]": (cokriging.neg_log_marginal_likelihood,
                                        lambda: ar1._starts(XMF_STARTS, 0),
                                        ar1.train_data),
        "NARGP level-0 NLL [8, 40, 40]": (
            gpr.neg_log_marginal_likelihood,
            lambda: nargp._starts(nargp.params[0], XMF_STARTS,
                                  torch.Generator(device=DEVICE).manual_seed(0)),
            nargp.train_data[0]),
    }
    for what, (loss_fn, starts, batch) in cases.items():
        run = lambda: training.multistart_adam(loss_fn, starts(), batch, steps,
                                               XMF_LR)
        run()
        ms = [1e3 * timed(run)[1] / steps for _ in range(rounds)]
        log(f"[timing] engine step, {XMF_STARTS} starts, {what}: ms per step "
            f"over {steps} steps, {rounds} rounds: "
            f"{', '.join(f'{t:.3f}' for t in ms)} ({gpu})")
        profile_run(f"ten engine steps, {what}", lambda: training.multistart_adam(
            loss_fn, starts(), batch, 10, XMF_LR), gpu)


# -- phase 9: the multi-fidelity BO driver --------------------------------------


def forrester_con(x):
    """g(x) = 0.55 - x <= 0: the constrained infill's constraint (feasible
    from 0.55 on, so the Forrester optimum at 0.757 stays feasible)."""
    return 0.55 - np.asarray(x)[:, 0]


def launch_vector(c5=0, c6=0, c7=0, c8=0):
    """counts() with #5, #6 (its phase B once per phase A: every n here fits
    one pass), #7 and #8."""
    return (0, 0, 0, 0, c5, c6, c7, c8, 0, 0, c6)


def add_counts(*cs):
    return tuple(sum(c[k] for c in cs) for k in range(11))


def surrogate_launches(kind, op, n_fid=2, f=0, steps=0):
    """counts() of one operation of an MF_BO surrogate of ``kind`` ("ar1",
    "nargp", "mf_dgp", "em", or "gpr" for a constraint GPR). ``op``:
    "fit", a fresh model trained for ``steps`` (the exact forms' engine
    steps, exact_expected_counts; the variational forms' build, as
    mf_expected_counts / em_expected_counts reckon it, and ``steps`` loss
    evaluations with their gradient; the GPR's Adam steps, one #7 each);
    "loss", one loss with its gradient (a warm lie refit's step);
    "request", a prediction at fidelity ``f`` (the fidelity rule's, a
    believer lie's, an acquisition evaluation's at the top fidelity). An
    AR(1) request factors its joint Gram (#7), a NARGP one factors levels
    0..f (#7 each); an MF-DGP one recomputes layer 1's Z_right (#8, #5), then
    projects layers 0..f (#8 each: two M) and runs their quadforms (#5); an
    EM one runs the whole chain whatever f (em_expected_counts)."""
    if kind in ("ar1", "nargp"):
        if op == "fit":
            return exact_expected_counts(kind, steps, n_fid=n_fid)
        return launch_vector(c7=1 if kind == "ar1" else f + 1)
    if kind == "gpr":
        return launch_vector(c7=steps if op == "fit" else 1)
    counts_of = mf_expected_counts if kind == "mf_dgp" else em_expected_counts
    if op == "fit":
        return counts_of(built=1, losses=steps)
    if op == "loss":
        return counts_of(losses=1)
    if kind == "mf_dgp":
        return launch_vector(c5=f + 2, c8=f + 2)
    return counts_of(requests=1)


@contextlib.contextmanager
def wrap_methods(rec, targets):
    """While the scope lasts, each (owner, name, fn, key) of ``targets`` puts
    ``fn`` (None: the original) in owner.name, its seconds added to
    rec["s"][key] where a key is given; on exit an instance's wrapper is
    deleted and a module's function put back. Yields ``rec``."""
    saved = [(owner, name, vars(owner).get(name, _UNSET))
             for owner, name, _, _ in targets]

    def timed_as(fn, key):
        def run(*args, **kwargs):
            out, dt = timed(lambda: fn(*args, **kwargs))
            rec["s"][key] += dt
            return out
        return run

    for owner, name, fn, key in targets:
        fn = fn or getattr(owner, name)
        setattr(owner, name, fn if key is None else timed_as(fn, key))
    try:
        yield rec
    finally:
        for owner, name, old in saved:
            if old is _UNSET:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


_UNSET = object()


def recorded_loop(bo):
    """Record what the loop ``bo`` does while the scope lasts: ``ops``, the
    operations the launch reckoning counts ((what, kind, fidelity, steps)),
    the seconds of its steps (``s``: surrogate fit, constraint fits,
    fidelity rule, lies; the acquisition is the rest of an infill) and each
    fresh batch state (``states``). The instance's methods are wrapped and
    restored on exit (wrap_methods)."""
    kind = bo.model_dic.get("type", "mf_dgp")
    rec = {"ops": [], "s": dict(fit=0.0, con=0.0, rule=0.0, lie=0.0),
           "states": []}
    methods = {name: getattr(bo, name) for name in (
        "_fit_model", "_make_train_con_models", "_fidelity_sigma",
        "_select_fidelity", "_lie_value", "_lie_at", "_fresh_batch_state")}

    def fit(Ys_n, seed):
        if kind in ("ar1", "nargp"):
            steps = int(bo.model_dic["iterations"])
        else:
            n1, n2, n3 = bo.model_dic["schedule"]
            steps = n1 + n2 + 2 * n3   # natural-gradient steps evaluate twice
        rec["ops"].append(("fit", kind, None, steps))
        return methods["_fit_model"](Ys_n, seed)

    def con_fits():
        if bo.n_con:
            rec["ops"] += [("fit", "gpr", None,
                            int(bo.model_C_dic["iterations"]))] * bo.n_con
        return methods["_make_train_con_models"]()

    def sigma(model, x_new, f, S=100):
        rec["ops"].append(("request", kind, f, 0))
        return methods["_fidelity_sigma"](model, x_new, f, S)

    def select(model, x_new, S=100, extra_queries=()):
        rec["ops"].append(("pick", kind, None, 0))
        return methods["_select_fidelity"](model, x_new, S, extra_queries)

    def lie_value(st, x_new, f, lie):
        if lie == "believer":
            rec["ops"].append(("request", kind, f, 0))
        return methods["_lie_value"](st, x_new, f, lie)

    def lie_at(st, x_new, f, lie, lie_train_iterations):
        if kind in ("mf_dgp", "em"):
            steps = 200 if lie_train_iterations is None else lie_train_iterations
            rec["ops"] += [("loss", kind, None, 0)] * steps
        rec["ops"] += [("request", "gpr", None, 0)] * bo.n_con
        return methods["_lie_at"](st, x_new, f, lie, lie_train_iterations)

    def fresh(IC):
        st = methods["_fresh_batch_state"](IC)
        rec["states"].append(st)
        return st

    return wrap_methods(rec, [
        (bo, "_fit_model", fit, "fit"),
        (bo, "_make_train_con_models", con_fits, "con"),
        (bo, "_fidelity_sigma", sigma, None),
        (bo, "_select_fidelity", select, "rule"),
        (bo, "_lie_value", lie_value, None), (bo, "_lie_at", lie_at, "lie"),
        (bo, "_fresh_batch_state", fresh, None)])


def reckon_loop(bo, ops, iterations_DE=None):
    """counts() reckoned from a loop's recorded operations: each fit, loss,
    request and constraint fit as surrogate_launches counts it, and each
    pick's DE maximization, (1 + generations) evaluations of the criterion
    on the surrogate at the top fidelity (and, constrained, of each
    constraint GPR); the generations are MFBO_RUN's unless given."""
    total = launch_vector()
    top = bo.n_fid - 1
    generations = (MFBO_RUN["iterations_DE"] if iterations_DE is None
                   else iterations_DE)
    for what, kind, f, steps in ops:
        if what == "pick":
            evaluations = 1 + generations
            one = add_counts(surrogate_launches(kind, "request", bo.n_fid, top),
                             *[surrogate_launches("gpr", "request")] * bo.n_con)
            total = add_counts(total, tuple(evaluations * c for c in one))
        else:
            total = add_counts(total, surrogate_launches(
                kind, what, bo.n_fid, f if f is not None else top, steps))
    return total


def check_archives(tag, bo, n0):
    """The loop's bookkeeping: the archives grew by the chosen fidelities'
    counts and hold real evaluations only (every Y row is its fidelity's
    value at its X row: no lie reached them), the cost is the sum of the
    chosen fidelities' costs, and the best trace, one entry per evaluation,
    finite, never rising and at or above the high fidelity's minimum."""
    trace = np.asarray(bo.best_trace, dtype=float)
    ok = len(trace) == 1 + len(bo.fidelity_choices) == len(bo.cost_trace)
    for f in range(bo.n_fid):
        ok &= len(bo.X[f]) == len(bo.Y[f]) == n0[f] + bo.fidelity_choices.count(f)
        ok &= bool(np.allclose(bo.Y[f], np.asarray(bo.fidelities[f](bo.X[f]))
                               .reshape(-1, 1), rtol=1e-12, atol=1e-12))
        if bo.n_con:
            ok &= bool(np.allclose(bo.C[f], bo._eval_cons(bo.X[f]),
                                   rtol=1e-12, atol=1e-12))
    ok &= abs(bo.cost_spent - sum(bo.costs[f] for f in bo.fidelity_choices)) < 1e-9
    ok &= bool(np.all(np.isfinite(trace)) and np.all(np.diff(trace) <= 0))
    if not ok:
        raise AssertionError(f"[mf_bo] {tag}: bookkeeping: best {trace}, "
                             f"fidelities {bo.fidelity_choices}, cost "
                             f"{bo.cost_spent}, archives "
                             f"{[len(x) for x in bo.X]} from {n0}")


def drive_loop(phase, tag, bo, steps, gpu, record, note, reckon, check, used,
               summary):
    """Drive ``bo`` through ``steps`` (one callable an infill) inside
    ``record(bo)`` (the loop's recorder: it yields rec, the loop's operations
    and the seconds of its steps), with the launches zeroed just before and
    read just after. ``note(bo)``, called before an infill, returns the
    function that words its log line from (seconds, the split of rec["s"],
    #7 launches); then ``check()`` holds the loop's bookkeeping, the
    launches must equal ``reckon(rec)`` and those of the kernels
    ``used(rec)`` none be zero; ``summary()`` words the loop's result.
    Returns (the launches, rec)."""
    zero_counts()
    with record(bo) as rec:
        for j, step in enumerate(steps):
            before, s0, line = counts(), dict(rec["s"]), note(bo)
            _, dt = timed(step)
            part = {k: rec["s"][k] - s0[k] for k in s0}
            log(f"[{phase}] {tag} infill {j}: "
                f"{line(dt, part, counts()[6] - before[6])} ({gpu})")
    launched, expect = counts(), reckon(rec)
    check()
    log(f"[{phase}] {tag}: {summary()}; launches {COUNTED} {launched}, "
        f"reckoned {expect} ({gpu})")
    if launched != expect or min(launched[k] for k in used(rec)) < 1:
        raise AssertionError(f"[{phase}] {tag}: launches {launched}, reckoned "
                             f"{expect}")
    return launched, rec


def drive(tag, bo, steps, gpu, floor=None):
    """drive_loop for an MF_BO loop: each infill's seconds split into
    surrogate fit, constraint fits, acquisition, fidelity rule and lies
    (recorded_loop), with its #7 launches, fidelities and best value;
    bookkeeping as check_archives, the best trace at or above ``floor``, the
    launches equal to those reckoned from the loop (reckon_loop) and those
    of the kernels its surrogate runs nonzero (#7 for every kind, #5, #6 and
    #8 for the variational ones). Returns (the launches, the loop's batch
    states)."""
    kind = bo.model_dic.get("type", "mf_dgp")
    n0 = [len(x) for x in bo.X]

    def note(bo):
        k0 = len(bo.fidelity_choices)
        return lambda dt, part, n7: (
            f"{dt:.3f} s: surrogate fit {part['fit']:.3f}, constraint fits "
            f"{part['con']:.3f}, acquisition {dt - sum(part.values()):.3f}, "
            f"fidelity rule {part['rule']:.3f}, lies {part['lie']:.3f}; #7 "
            f"launches {n7}; fidelities {bo.fidelity_choices[k0:]}, best "
            f"{bo.best_trace[-1]:.6f}, cost {bo.cost_spent:.2f}")

    def check():
        check_archives(tag, bo, n0)
        if floor is not None and not min(bo.best_trace) >= floor:
            raise AssertionError(f"[mf_bo] {tag}: best {bo.best_trace} below "
                                 f"the minimum {floor}")

    used = (6,) if kind in ("ar1", "nargp") else (4, 5, 6, 7, 10)
    launched, rec = drive_loop(
        "mf_bo", tag, bo, steps, gpu, recorded_loop, note,
        lambda rec: reckon_loop(bo, rec["ops"]), check, lambda rec: used,
        lambda: (f"best trace "
                 f"{np.array2string(np.asarray(bo.best_trace), precision=6)}, "
                 f"fidelities {bo.fidelity_choices}, cost {bo.cost_spent:.2f}"))
    return launched, rec["states"]


class FixedDraws:
    """An MF_BO surrogate seen through its pure model function, at given
    parameters and dtype, with fixed unit normals for the MF-DGP (``normals``
    by sample count, in the order mf_normals gives them): what the fidelity
    rule and the believer lie read, computed alike in every arm of a
    comparison."""

    def __init__(self, model, params, dtype, normals):
        self.name, self.model, self.params = model.name, model, params
        self.dtype, self.normals = dtype, normals

    @torch.no_grad()
    def predict_f(self, X, S=1, fidelity=None):
        from dgp_tpu_torch.models import cokriging
        from dgp_tpu_torch.models import mf_dgp as tmf

        X = torch.as_tensor(np.asarray(X), dtype=self.dtype, device=DEVICE)
        if self.name == "ar1":
            data = tuple(tuple(t.to(self.dtype) for t in ts)
                         for ts in self.model.train_data)
            mean, var = cokriging.predict_f(self.params, data, X, fidelity)
            return mean[None], var[None]
        return tmf.predict_f(self.params, X, S, fidelity=fidelity,
                             noise=[z.to(self.dtype) for z in self.normals[S]])


def compare_mf_bo(tag, bo, st):
    """The fidelity rule's sigma_f and the believer lie's value at every
    fidelity, over MFBO_ROWS rows of the box, through MF_BO's own
    _fidelity_sigma and _lie_value on a trained batch state's surrogate
    (FixedDraws): the kernels on (#7, and for the MF-DGP #5 and #8, launched
    as surrogate_launches reckons the requests) against the plain versions
    (use_kernels off), and each against the float64 twin (f64_twin,
    hold_to_f64), both within TOL_REQUEST of scale plus twice the plain
    versions' own error against float64, that term at most WITNESS_CAP (a
    sigma is the root of a moment-matched variance that cancels: float32
    itself is ~1e-3 of scale off float64 there)."""
    import copy

    from dgp_tpu_torch.config import kernels_scope

    model = st["model"]
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    normals = ({S: mf_normals(model, gen, rows=1, S=S) for S in (64, 100)}
               if model.name == "mf_dgp" else None)
    rows = np.linspace(0.0, 1.0, MFBO_ROWS)[:, None]

    def arm(params, dtype):
        surrogate = FixedDraws(model, params, dtype, normals)
        state = dict(st, model=surrogate)
        out = [[bo._fidelity_sigma(surrogate, x[None], 0) for x in rows]]
        out += [[bo._lie_value(state, x[None], f, "believer") for x in rows]
                for f in range(bo.n_fid)]
        return [torch.tensor(v, dtype=torch.float64) for v in out]

    kind = "mf_dgp" if model.name == "mf_dgp" else "ar1"
    expect = add_counts(*[surrogate_launches(kind, "request", bo.n_fid, f)
                          for f in (0, *range(bo.n_fid))] * MFBO_ROWS)
    before = counts()
    on = arm(model.params, torch.float32)
    launched = tuple(a - b for a, b in zip(counts(), before))
    if launched != expect:
        raise AssertionError(f"[mf_bo] {tag} comparison: launches {launched},"
                             f" reckoned {expect}")
    with kernels_scope(False):
        plain = arm(model.params, torch.float32)
    with f64_twin():
        ref = arm(copy.deepcopy(model.params).double(), torch.float64)
    names = ["sigma_0"] + [f"lie at fidelity {f}" for f in range(bo.n_fid)]
    hold_on_vs_off(f"[mf_bo] {tag}: fidelity rule and believer lies over "
                   f"{MFBO_ROWS} rows", names, on, plain, ref)
    hold_to_f64(f"[mf_bo] {tag}: fidelity rule and believer lies, the kernels "
                f"vs the plain versions", names, ref, on, plain)


def hold_on_vs_off(what, names, on, plain, ref, cap=WITNESS_CAP):
    """Each output with the kernels on finite and within TOL_REQUEST of the
    plain versions' largest |value| plus twice the plain versions' own
    error against the float64 twin ``ref``, that term at most ``cap``."""
    report = []
    for name, a, b, r in zip(names, on, plain, ref):
        err = float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
        own = float((b - r).abs().max()) / (float(r.abs().max()) or 1.0)
        limit = TOL_REQUEST + min(2 * own, cap)
        report.append(f"{name} {err:.2e} (limit {limit:.2e})")
        if not (err <= limit and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{what}: {name} differs with the kernels "
                                 f"off by {err:.2e}, limit {limit:.2e}")
    log(f"{what}, kernels on vs off, err / max|off| (tol {TOL_REQUEST} + 2x "
        f"off's own error against float64, at most {cap}): "
        + ", ".join(report))


def idle_share(what, fn, gpu, tag="mf_bo"):
    """The device's idle share over one run of ``fn`` under torch.profiler
    (CUDA activity only: an infill makes ~10^5 launches), logged under
    ``tag``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    device = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    if not device:
        log(f"[{tag}] {what}: the profiler saw no device time: idle share "
            f"not measured")
        return
    busy = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in device)
    log(f"[{tag}] {what} under the profiler: wall {1e3 * wall:.1f} ms, device "
        f"busy {busy:.1f} ms over {launches} device operations, idle "
        f"{1 - busy / (1e3 * wall):.1%} ({gpu})")


def run_mf_bo(gpu):
    """The multi-fidelity BO driver through the entry points a user calls,
    MF_BO on the card in float32, on the Forrester pair (DoE MFBO_DOE, seed
    MFBO_SEED) with the default AR(1) surrogate cut to MFBO_STEPS steps:
    three infills (the third by suggest() and observe()) and a batch of two
    with a believer lie; one PoF infill under g(x) = 0.55 - x; one infill
    each of the NARGP surrogate, of the MF-DGP (a batch of two: the lie's
    200-step warm refit) and of the EM surrogate on Park_VD 30/6 (the em
    phase's data, projections x[:, :2]). Each loop as drive() checks it;
    then compare_mf_bo at the AR(1) and MF-DGP batch states, and the idle
    share of one AR(1) infill. Returns the path's launches (the
    comparisons' and the profiled infill's left out)."""
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.bo.mf_bo import MF_BO
    from dgp_tpu_torch.utils.test_functions import (forrester_high,
                                                    forrester_low,
                                                    park_vd_high, park_vd_low)

    fids = [forrester_low, forrester_high]
    forrester = dict(fidelities=fids, DoE_sizes=MFBO_DOE, d=1,
                     seed=MFBO_SEED, device=DEVICE)
    log(f"[mf_bo] the Forrester pair, DoE {MFBO_DOE}, seed {MFBO_SEED}, "
        f"float32; cut from the bake-off's AR(1) cell: Adam 2,000 -> "
        f"{MFBO_STEPS} steps (8 starts), DE 300x400 -> "
        f"{MFBO_RUN['popsize_DE']}x{MFBO_RUN['iterations_DE']}, samples 500 "
        f"-> {MFBO_RUN['num_samples']}, 10 infills -> 4; the constraint GPR "
        f"2,000 -> {MFBO_CON['iterations']} Adam steps; the variational "
        f"schedule (200, 200, 400) -> (20, 10, 10)")
    bo = MF_BO(model_dic=MFBO_SPECS["ar1"], **forrester)

    def ask_tell():
        x, f = bo.suggest(**MFBO_RUN)
        bo.observe(x, fids[f](x), f)

    launches = []
    launched, states = drive("ar1", bo, [
        lambda: bo.run(1, **MFBO_RUN), lambda: bo.run(1, **MFBO_RUN),
        ask_tell, lambda: bo.run(1, batch_size=2, **MFBO_RUN)], gpu,
        floor=FORRESTER_FLOOR)
    launches.append(launched)
    ar1_state = states[-1]
    bo_c = MF_BO(model_dic=MFBO_SPECS["ar1"], constraints=[forrester_con],
                 model_C_dic=MFBO_CON, **forrester)
    launches.append(drive("ar1, PoF under g(x) = 0.55 - x", bo_c, [
        lambda: bo_c.run(1, constraint_handling="PoF", **MFBO_RUN)], gpu,
        floor=FORRESTER_FLOOR)[0])
    bo_n = MF_BO(model_dic=MFBO_SPECS["nargp"], **forrester)
    launches.append(drive("nargp", bo_n, [lambda: bo_n.run(1, **MFBO_RUN)],
                          gpu, floor=FORRESTER_FLOOR)[0])
    bo_m = MF_BO(model_dic=MFBO_SPECS["mf_dgp"], **forrester)
    launched, states = drive("mf_dgp", bo_m, [
        lambda: bo_m.run(1, batch_size=2, **MFBO_RUN)], gpu,
        floor=FORRESTER_FLOOR)
    launches.append(launched)
    mf_state = states[-1]
    X = [lhs(EM_DIN[0], EM_N[0], seed=123), lhs(EM_DIN[1], EM_N[1], seed=0)]
    bo_e = MF_BO(fidelities=[park_vd_low, park_vd_high], X=X,
                 Y=[park_vd_low(X[0]), park_vd_high(X[1])],
                 model_dic=MFBO_SPECS["em"],
                 projections=[lambda x: np.asarray(x)[:, :EM_DIN[0]]],
                 seed=MFBO_SEED, device=DEVICE)
    launches.append(drive(f"em (Park_VD {EM_N[0]}/{EM_N[1]})", bo_e,
                          [lambda: bo_e.run(1, **MFBO_RUN)], gpu)[0])
    total = add_counts(*launches)
    log(f"[mf_bo] launches on the path {COUNTED}: {total} ({gpu})")

    compare_mf_bo("ar1 batch state", bo, ar1_state)
    compare_mf_bo("mf_dgp batch state", bo_m, mf_state)
    bo_p = MF_BO(model_dic=MFBO_SPECS["ar1"], **forrester)
    idle_share("one AR(1) infill", lambda: bo_p.run(1, **MFBO_RUN), gpu)
    return total


# -- phase 10: the multi-objective deep GP ----------------------------------------


def mo_data():
    """multi_obj_1D_4's DoE as compat/validate_mo_dgp.py draws it (MO_N LHS
    points, seed 0), x and both objectives normalized: (X list, Y list,
    (mean, sd) of the raw x)."""
    from dgp_tpu_torch.bo.doe import lhs
    from dgp_tpu_torch.bo.problems import multi_obj_1D_4

    problem = multi_obj_1D_4()
    X_ = lhs(problem.dim, MO_N, seed=0)
    F = np.array([np.ravel(problem.fun(x)) for x in X_])
    norm = lambda a: (a - a.mean(0)) / a.std(0)
    X = norm(X_)
    return ([X, X.copy()], [norm(F[:, :1]), norm(F[:, 1:])],
            (X_.mean(0), X_.std(0)))


def mo_model(seed=0, mesh=None):
    """The multi_obj_1D_4 configuration (MO_*) as a MultiObjDeepGP on the
    card in float32 (on ``mesh`` where given)."""
    from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP

    X, Y, _ = mo_data()
    return MultiObjDeepGP(X, Y, loop=MO_LOOP, num_samples=MO_S, seed=seed,
                          mesh=mesh, device=DEVICE, dtype=torch.float32)


def mo_request_rows():
    from dgp_tpu_torch.bo.doe import lhs

    mean, sd = mo_data()[2]
    return (lhs(1, MO_REQUEST, seed=7) - mean) / sd


def mo_kuu():
    """[(name, (A, A64))]: the MO model's own Kuu stacks, each with its
    float64 twin (kuu_twins): [1, 10, 10] (layer 0 at its Z, as each
    Z_right factors it) and [2, 10, 10] (both layers at the recomputed
    inducing inputs: the stack each loss, propagation and KL factors)."""
    from dgp_tpu_torch.models.mf_dgp import compute_full_zs

    params = mo_model().params
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    with torch.no_grad():
        zs = compute_full_zs(params.layers, gen, pad_cols=1)
    return [("MO layer 0", kuu_twins([params.layers[0]], [zs[0]])),
            ("MO layers 0 and 1", kuu_twins(list(params.layers), zs))]


def check_mo_kernels():
    """#5 and #6 at the MO model's shapes (MO_QUADFORM), with and without
    t1, with the repeat and NaN runs; #7 and #8 on its Kuu stacks
    (mo_kuu), held to their float64 twins. Returns the largest errors
    [#5, #6, #7, #8]."""
    err = [0.0] * 4
    for seed, (D, Mi, n) in enumerate(MO_QUADFORM):
        for with_t1 in (False, True):
            err[0] = max(err[0], check_quadform(D, Mi, n, with_t1, 280 + seed))
            err[1] = max(err[1], check_quadform_backward(D, Mi, n, with_t1,
                                                         380 + seed))
    for name, stack in mo_kuu():
        for inverse in (False, True):
            err[2 + inverse] = max(err[2 + inverse], check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack))
    return err


def mo_expected_counts(built=0, losses=0, requests=0, guards=0, scores=0):
    """counts() reckoned for the MO model at loop MO_LOOP (layers of D = 1,
    M = 10, both non-whitened, one (M, white) group), each propagation
    recomputing its own Z_right and applying c = 2·loop + 2 conditionals
    (3 at loop 0). Building it: #7 per layer (the initial q_sqrt) and
    init_layers_mf's Z_right (layer 0 at 100 x 10 points: #8 for its
    projection, #5). A loss evaluation with its gradient: the ELBO's own
    Z_right (#8, #5 at 50 x 10 points) and the KLs' projections (#8), then
    per objective a propagation: its Z_right (#8, #5), the layers'
    projections (#8) and c conditionals (#5 each); the backward runs #6
    and its phase B once per #5 but one: objective 0's data term does not
    read its propagation's last conditional (objective 1's), so no
    gradient reaches that #5. A guard evaluation (the natural-gradient
    step's loss at its candidate, no gradient): the same forward. A
    request: one propagation. A restart score ("fit"): one propagation per
    objective."""
    c = 2 * MO_LOOP + 2 + (MO_LOOP == 0)
    per_loss = (1 + 2 * (1 + c), 2 + 2 * 2)
    c5 = built + per_loss[0] * (losses + guards) + (1 + c) * (
        requests + 2 * scores)
    c6 = (per_loss[0] - 1) * losses
    c8 = built + per_loss[1] * (losses + guards) + 2 * (requests + 2 * scores)
    return (0, 0, 0, 0, c5, c6, 2 * built, c8, 0, 0, c6)


def mo_moves(name, nat):
    """The phase from which the MO model's tensor ``name`` moves: as the MF
    model's (mf_moves), layer 0's z and layer 1's z_left from phase 2 and
    the likelihood in phase 3, and q in Adam's phase 3; but None for q
    under natural gradients. From this init (q_sqrt scaled 1e-2 against
    the 1e-6 White anchor) most natural-gradient steps leave the
    natural-parameter cone and natgrad_step_multi keeps that layer's q: in
    a float32 CPU rehearsal of the cut schedule, layer 0's q_mu moved in 1
    of 20 steps and layer 1's in 12, and in float64 at 3 samples no q moved
    in the first 4 steps."""
    if nat and name.split(".")[-1] in ("q_mu", "q_sqrt"):
        return None
    return mf_moves(name, nat)


@contextlib.contextmanager
def guard_evaluations():
    """Count, in a one-element list, the loss evaluations that the
    natural-gradient steps' guard makes inside the scope (at the candidate,
    without a gradient: their number depends on how many steps it rejects,
    each rejection one more)."""
    from dgp_tpu_torch.models import training

    count = [0]
    step = training.natgrad_step_multi

    def counted(qs, loss_fn, *args, **kwargs):
        def loss(candidate):
            count[0] += not torch.is_grad_enabled()
            return loss_fn(candidate)
        return step(qs, loss, *args, **kwargs)

    training.natgrad_step_multi = counted
    try:
        yield count
    finally:
        training.natgrad_step_multi = step


def run_mo(gpu):
    """The multi-objective path (run_staged): the multi_obj_1D_4 model,
    optimize_nat_adam(restarts=1) for MO_NAT steps, optimize_adam for
    MO_ADAM, a predict of MO_REQUEST rows; launches as mo_expected_counts
    reckons them, the guard's evaluations counted as they happen."""
    with guard_evaluations() as guards:
        return run_staged(
            "mo", mo_model, MO_NAT, MO_ADAM, mo_request_rows(),
            lambda **kw: mo_expected_counts(guards=guards[0], **kw),
            f"multi_obj_1D_4 (N {MO_N}, Z default, loop {MO_LOOP}, S {MO_S}, "
            f"float32)", gpu, lr_adam=0.01, nat_options={"restarts": 1},
            moves=mo_moves, moved="z and z_left moved from phase 2, the "
            "likelihood and q in phase 3")


@contextlib.contextmanager
def restart_candidates():
    """Record, in the yielded list, each MO-DGP restart candidate's fit
    score and a copy of its parameters (MultiObjDeepGP._restart_score
    wrapped: one per schedule of optimize_nat_adam(restarts=...)) while the
    scope lasts."""
    from dgp_tpu_torch.models.mo_dgp import MultiObjDeepGP

    seen = []
    score = MultiObjDeepGP._restart_score

    def recording(self, criterion, eval_key):
        s = score(self, criterion, eval_key)
        seen.append((s, {k: v.clone() for k, v in
                         self.params.state_dict().items()}))
        return s

    MultiObjDeepGP._restart_score = recording
    try:
        yield seen
    finally:
        MultiObjDeepGP._restart_score = score


def run_mo_restarts(gpu):
    """One optimize_nat_adam(restarts="auto", max_restarts=MO_RESTARTS) at
    MO_NAT: every candidate's fit score recorded with its parameters; one
    schedule if the first scores at least MO_THRESHOLD, else MO_RESTARTS;
    the kept parameters bit for bit those of the best finite score; the
    launches reckoned as that many schedules and scores (mo_expected_counts).
    Returns the path's launches."""
    zero_counts()
    model = mo_model()
    n1, n2, n3 = MO_NAT
    with restart_candidates() as seen, guard_evaluations() as guards:
        losses, dt = timed(lambda: model.optimize_nat_adam(
            iterations1=n1, iterations2=n2, iterations3=n3, messages=0,
            restarts="auto", max_restarts=MO_RESTARTS,
            restart_threshold=MO_THRESHOLD))
    scores = [s for s, _ in seen]
    runs = 1 if scores[0] >= MO_THRESHOLD else MO_RESTARTS
    if len(scores) != runs or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"[mo] restarts: scores {scores}, {runs} runs "
                             f"expected; losses {losses}")
    best = None
    for i, s in enumerate(scores):
        if best is None or (math.isfinite(s) and (
                not math.isfinite(scores[best]) or s > scores[best])):
            best = i
    kept = model.params.state_dict()
    if not all(torch.equal(kept[k], v) for k, v in seen[best][1].items()):
        raise AssertionError(f"[mo] restarts: the kept parameters are not "
                             f"those of candidate {best} (scores {scores})")
    launched = counts()
    expect = mo_expected_counts(built=1, losses=runs * (n1 + n2 + 2 * n3),
                                guards=guards[0], scores=runs)
    log(f"[mo] optimize_nat_adam(restarts=\"auto\", max_restarts="
        f"{MO_RESTARTS}) {n1} + {n2} + {n3} steps: {runs} schedules in "
        f"{dt:.2f} s, fit scores (worst train r2) "
        f"{', '.join(f'{s:.4f}' for s in scores)}, kept candidate {best} bit "
        f"for bit; {guards[0]} guard evaluations; launches {COUNTED} "
        f"{launched}, reckoned {expect} ({gpu})")
    if launched != expect:
        raise AssertionError(f"[mo] restarts: launches {launched}, reckoned "
                             f"{expect}")
    return launched


def mo_normals(model, gen, rows=None, S=MO_S):
    """Fixed unit normals in the order the MO functions draw them: for a
    request of ``rows`` rows, one propagation's (its Z_right [50, M_1, 1],
    the seed column [rows, 1], then one [S, rows, 1] per conditional) or,
    with ``rows`` None, the ELBO's (its own Z_right, then one propagation's
    at each objective's N_f rows)."""
    M1 = model.params.layers[1].z_left.shape[0]
    c = 2 * model.loop + 2 + (model.loop == 0)
    propagation = lambda n: [(50, M1, 1), (n, 1)] + [(S, n, 1)] * c
    if rows is None:
        shapes = [(50, M1, 1)] + [shape for x in model._X
                                  for shape in propagation(x.shape[0])]
    else:
        shapes = propagation(rows)
    return [torch.randn(shape, generator=gen, device=DEVICE)
            for shape in shapes]


def compare_mo(model):
    """compare_on_off for the MO model at its trained state: a 1,000-row
    request at 250 samples and a loss, the gradients of layer 0's z and
    layer 1's z_left nonzero. The 1e-6 White anchor of objective 0 makes
    the loss stiff (its initial value ~1e8), so float32 is itself far from
    float64 in the gradients: they are held by the witness rule
    (``gradient_witness``), as EM's."""
    from dgp_tpu_torch.models import mo_dgp as tmo

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    zr = mo_normals(model, gen, rows=MO_REQUEST, S=MO_PREDICT_S)
    zl = mo_normals(model, gen)
    cast = lambda xs, dtype: [x.to(dtype) for x in xs]
    compare_on_off(
        "mo", model, mo_request_rows(),
        lambda params, X, dtype: tmo.predict_y(
            params, X, MO_PREDICT_S, loop=model.loop, noise=cast(zr, dtype)),
        lambda params, dtype: tmo.elbo(
            params, cast(model._X, dtype), cast(model._Y, dtype), MO_S,
            loop=model.loop, noise=cast(zl, dtype)),
        mo_expected_counts(requests=1), mo_expected_counts(losses=1),
        ["layers.0.z", "layers.1.z_left"], gradient_witness=True)


def time_mo(model, gpu):
    time_staged(f"MO (multi_obj_1D_4, N {MO_N}, loop {MO_LOOP}, S {MO_S})",
                model, mo_request_rows(), gpu)


# -- phase 11: the multi-objective BO driver ----------------------------------------


def mo_bo_models():
    """Untrained surrogates of the mo_bo phase's three forms, as MO_BO builds
    them on the multi_obj_1D_4 DoE (MOBO_N points, seed MOBO_SEED, bucket
    8): the coupled MultiObjDeepGP (Z padded from 10 to 16 rows), the DGP
    pair (Z = X padded to 16) and the GPR pair (rows padded to 16)."""
    from dgp_tpu_torch.bo.mo_bo import MO_BO
    from dgp_tpu_torch.bo.problems import get

    out = {}
    for name, spec in (("mo_dgp", MOBO_COUPLED), ("two_dgp", MOBO_DGP),
                       ("two_gpr", MOBO_GPR)):
        bo = MO_BO(problem=get("multi_obj_1D_4"), DoE_size=MOBO_N,
                   model_dic=spec, seed=MOBO_SEED, device=DEVICE)
        out[name] = bo.make_model(*bo._normalized()[:2], seed=0)
    return out


def gpr_gram_twins(model):
    """(A, A64): a GPR's noise-augmented padded Gram [1, n_pad, n_pad] at
    its train_data, and its float64 twin under the float32 jitter."""
    import copy

    from dgp_tpu_torch.models import gpr

    X, _, w = model.train_data
    with torch.no_grad():
        A = gpr._masked_gram(model.params, X, w)[None]
        with f64_twin():
            A64 = gpr._masked_gram(copy.deepcopy(model.params).double(),
                                   X.double(), w.double())[None]
    return A, A64


def mo_bo_stacks():
    """[(name, (A, A64), inverses)]: the mo_bo path's stacks with their
    float64 twins (kuu_twins, gpr_gram_twins), and which of #7 (False) and
    #8 (True) factor each: the coupled model's Kuu [1, 16, 16] (layer 0, as
    each Z_right factors it) and [2, 16, 16] (both layers at the recomputed
    inducing inputs), a DGP's Kuu [2, 16, 16] (#7 builds each layer's
    q_sqrt, #8 projects both) and a GPR's padded Gram [1, 16, 16] (#7)."""
    from dgp_tpu_torch.models.mf_dgp import compute_full_zs

    models = mo_bo_models()
    params = models["mo_dgp"].params
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    with torch.no_grad():
        zs = compute_full_zs(params.layers, gen, pad_cols=1)
    dgp = models["two_dgp"][0].params.layers
    both = (False, True)
    return [("MO_BO coupled layer 0",
             kuu_twins([params.layers[0]], [zs[0]]), both),
            ("MO_BO coupled layers 0 and 1",
             kuu_twins(list(params.layers), zs), both),
            ("MO_BO DGP", kuu_twins(list(dgp), [l.z for l in dgp]), both),
            ("MO_BO GPR Gram", gpr_gram_twins(models["two_gpr"][0]),
             (False,))]


def check_mo_bo_kernels():
    """#5 and #6 at the path's shapes (MOBO_QUADFORM: D = 1 and M = 16, the
    padded inducing rows), with and without t1, with the repeat and NaN
    runs; #7 and #8 on its stacks (mo_bo_stacks), held to their float64
    twins. Returns the largest errors [#5, #6, #7, #8]."""
    err = [0.0] * 4
    for seed, (D, Mi, n) in enumerate(MOBO_QUADFORM):
        for with_t1 in (False, True):
            err[0] = max(err[0], check_quadform(D, Mi, n, with_t1, 430 + seed))
            err[1] = max(err[1], check_quadform_backward(D, Mi, n, with_t1,
                                                         480 + seed))
    for name, stack, inverses in mo_bo_stacks():
        for inverse in inverses:
            err[2 + inverse] = max(err[2 + inverse], check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack))
    return err


def mobo_launches(kind, op, steps=0):
    """counts() of one operation of an MO_BO surrogate: ``kind`` "gpr" (one
    exact GPR), "dgp" (one DGP of two non-whitened layers of M = 16, one
    (M, white) group) or "mo_dgp" (the coupled model at loop MO_LOOP,
    mo_expected_counts). ``op``: "fit", built and trained for ``steps``
    losses with their gradient (a GPR factors its Gram once a step; a DGP
    is built through #7 per layer, and a loss runs #8 once, #5 and #6 per
    layer); "loss", one loss with its gradient (a lie's warm refit step);
    "request", one prediction (an EHVI evaluation's moments, a believer
    mean); "grad request", one with the gradient in x (an Adam step's
    evaluation: #6 once per conditional on x, none for the coupled model's
    Z_right, which x does not reach)."""
    if kind == "gpr":
        return launch_vector(c7=steps if op == "fit" else 1)
    if kind == "dgp":
        n = steps if op == "fit" else 1
        grad = op != "request"
        return launch_vector(c5=2 * n, c6=2 * n if grad else 0,
                             c7=2 if op == "fit" else 0, c8=n)
    if op == "fit":
        return mo_expected_counts(built=1, losses=steps)
    if op == "loss":
        return mo_expected_counts(losses=1)
    c = 2 * MO_LOOP + 2 + (MO_LOOP == 0)
    request = mo_expected_counts(requests=1)
    return add_counts(request, launch_vector(c6=c)) if op == "grad request" \
        else request


def ehvi_evaluation(kind, n_con, grad=False, front=True):
    """counts() of one acquisition evaluation: the form's moments (two_gpr:
    two GPR requests, two_dgp: two DGP requests, mo_dgp: one coupled
    request; none for the PoF-only bootstrap, ``front`` false) and one
    predict_y of each constraint GPR."""
    op = "grad request" if grad else "request"
    parts = [mobo_launches("gpr", "request")] * n_con
    if front:
        if kind == "mo_dgp":
            parts.append(mobo_launches("mo_dgp", op))
        else:
            parts += [mobo_launches(kind[4:], op)] * 2
    return add_counts(*parts) if parts else launch_vector()


@contextlib.contextmanager
def recorded_mo_loop(bo):
    """Record what the MO_BO loop ``bo`` does while the scope lasts: ``ops``,
    the operations the launch reckoning counts (("fit", kind, steps),
    ("loss" | "request", kind, count), ("pick", form, front, n_con, DE
    evaluations, Adam evaluations with the gradient, without)); ``s``, the
    seconds of its steps (surrogate fit, constraint fits, DE, Adam, lies;
    the rest of an infill is the host's bookkeeping); ``states``, each fresh
    batch state; ``guards``, the natural-gradient guard's evaluations
    (guard_evaluations). The instance's methods, MO_BO's optimize_EHVI and
    DE's minimize and adam_refine are wrapped and restored on exit
    (wrap_methods)."""
    from dgp_tpu_torch.bo import de
    from dgp_tpu_torch.bo import mo_bo as mo_bo_mod
    from dgp_tpu_torch.bo.ehvi import _mo_model_state

    rec = {"ops": [], "s": dict(fit=0.0, con=0.0, de=0.0, adam=0.0, lie=0.0),
           "states": []}
    methods = {name: getattr(bo, name) for name in (
        "_train_model", "_make_train_con_models", "_fantasy_objectives",
        "_lie_at", "_fresh_batch_state")}
    optimize_EHVI = mo_bo_mod.optimize_EHVI

    def train(model, sched, restarts):
        if isinstance(model, list):
            for m in model:
                if m.name == "gpr":
                    steps = int(bo.model_dic.get("iterations", 2000))
                else:
                    if sched[1]:
                        raise AssertionError("[mo_bo] the DGP pair's launches "
                                             "are reckoned for Adam alone")
                    steps = sched[0]
                rec["ops"].append(("fit", m.name, steps))
        else:
            n1, n2, n3 = sched
            rec["ops"].append(("fit", "mo_dgp", n1 + n2 + 2 * n3))
        return methods["_train_model"](model, sched, restarts)

    def con_fits(Xn):
        if bo.n_con:
            steps = int(bo.model_C_dic.get("iterations", 2000))
            rec["ops"] += [("fit", "gpr", steps)] * bo.n_con
        return methods["_make_train_con_models"](Xn)

    def believer(model, x_n):
        if isinstance(model, list):
            rec["ops"] += [("request", m.name, 1) for m in model]
        else:
            rec["ops"].append(("request", "mo_dgp", 2))
        return methods["_fantasy_objectives"](model, x_n)

    def lie_at(st, x_n, lie_train_iterations):
        model = st["model"]
        if isinstance(model, list) and model[0].name == "dgp":
            steps = 200 if lie_train_iterations is None else lie_train_iterations
            rec["ops"].append(("loss", "dgp", 2 * steps))
        # each constraint's believer mean: the feasibility row and the lie
        rec["ops"].append(("request", "gpr", 2 * bo.n_con))
        return methods["_lie_at"](st, x_n, lie_train_iterations)

    def fresh(it):
        st = methods["_fresh_batch_state"](it)
        rec["states"].append(st)
        return st

    def optimize(model, YND, **kw):
        method = kw.get("method", "DE")
        de_evals = 1 + kw["iterations_DE"] if "DE" in method else 0
        adam = kw["iterations_adam"] if "Adam" in method else 0
        rec["ops"].append(("pick", _mo_model_state(model)[0], YND is not None,
                           len(kw.get("model_C") or ()), de_evals, adam,
                           1 if adam else 0))
        return optimize_EHVI(model, YND, **kw)

    with guard_evaluations() as rec["guards"], wrap_methods(rec, [
            (bo, "make_model", None, "fit"), (bo, "_train_model", train, "fit"),
            (bo, "_make_train_con_models", con_fits, "con"),
            (bo, "_fantasy_objectives", believer, None),
            (bo, "_lie_at", lie_at, "lie"),
            (bo, "_fresh_batch_state", fresh, None),
            (mo_bo_mod, "optimize_EHVI", optimize, None),
            (de, "minimize", None, "de"), (de, "adam_refine", None, "adam")]):
        yield rec


def reckon_mo_loop(ops, guards=0):
    """counts() reckoned from an MO_BO loop's recorded operations: each
    fit, loss and request as mobo_launches counts it, each pick's
    evaluations as ehvi_evaluation counts them, and the coupled model's
    natural-gradient guard evaluations (mo_expected_counts)."""
    total = mo_expected_counts(guards=guards)
    for op in ops:
        if op[0] == "pick":
            _, form, front, n_con, de_evals, grad, nograd = op
            one = ehvi_evaluation(form, n_con, front=front)
            with_grad = ehvi_evaluation(form, n_con, grad=True, front=front)
            part = add_counts(*[tuple((de_evals + nograd) * c for c in one),
                                tuple(grad * c for c in with_grad)])
        elif op[0] == "fit":
            part = mobo_launches(op[1], "fit", op[2])
        else:
            part = tuple(op[2] * c for c in mobo_launches(op[1], op[0]))
        total = add_counts(total, part)
    return total


def mo_objectives(problem, X):
    """The two objective columns of ``problem`` at the rows of X."""
    rows = [problem.fun(x) for x in np.asarray(X)]
    return [np.asarray([np.reshape(r[i], ()) for r in rows]) for i in (0, 1)]


def check_mo_archive(tag, bo, grows=False):
    """The archive holds real evaluations only (every F and C row is the
    problem's value at its X row: no lie reached it), every evaluated row
    lies in the box, one hypervolume per evaluation, finite and never
    falling (and, with ``grows``, ending above its start)."""
    trace = np.asarray(bo.hv_trace, dtype=float)
    F = mo_objectives(bo.problem, bo.X)
    n0 = len(bo.X) - len(bo.added_points)
    ok = len(trace) == len(bo.added_points) + 1
    ok &= all(np.allclose(bo.F[i][:, 0], F[i], rtol=1e-12, atol=1e-12)
              for i in (0, 1))
    if bo.n_con:
        ok &= bool(np.allclose(bo.C, bo._evaluate_cons(bo.X), rtol=1e-12,
                               atol=1e-12))
    ok &= bool(np.all((bo.X[n0:] >= 0) & (bo.X[n0:] <= 1)))
    ok &= bool(np.all(np.isfinite(trace)) and np.all(np.diff(trace) >= -1e-12))
    if grows:
        ok &= bool(trace[-1] > trace[0])
    if not ok:
        raise AssertionError(f"[mo_bo] {tag}: bookkeeping: hypervolume "
                             f"{trace}, {len(bo.X)} rows from {n0}")


def mo_drive(tag, bo, steps, gpu, grows=False):
    """drive_loop for an MO_BO loop: each infill's seconds split into
    surrogate fit, constraint fits, DE, Adam and lies (recorded_mo_loop),
    with its hypervolume; the archive as check_mo_archive checks it; the
    launches equal to those reckoned from the loop's recorded operations
    (reckon_mo_loop) and, of the kernels its surrogate runs (#7 for the GPR
    pair, #5-#8 for the deep forms), none zero. Returns (the launches, the
    recorded loop)."""
    def note(bo):
        k0 = len(bo.hv_trace)
        return lambda dt, part, n7: (
            f"{dt:.3f} s: surrogate fit {part['fit']:.3f}, constraint fits "
            f"{part['con']:.3f}, DE {part['de']:.3f}, Adam {part['adam']:.3f}, "
            f"lies {part['lie']:.3f}, the rest {dt - sum(part.values()):.3f}; "
            f"#7 launches {n7}; hypervolume "
            f"{', '.join(f'{v:.5f}' for v in bo.hv_trace[k0:])}")

    def used(rec):
        deep = any(op[0] == "fit" and op[1] != "gpr" for op in rec["ops"])
        return (4, 5, 6, 7, 10) if deep else (6,)

    return drive_loop(
        "mo_bo", tag, bo, steps, gpu, recorded_mo_loop, note,
        lambda rec: reckon_mo_loop(rec["ops"], rec["guards"][0]),
        lambda: check_mo_archive(tag, bo, grows), used,
        lambda: (f"hypervolume "
                 f"{np.array2string(np.asarray(bo.hv_trace), precision=5)}"))


def mobo_front(bo, st):
    """The padded front a batch state hands the acquisition (as _propose
    builds it)."""
    from dgp_tpu_torch.bo.ehvi import NDC, Y_ND, pad_front

    NDT = NDC(st["F_fant"], st["C_fant"], obj1_ascending=False)
    Fn = [(st["F_fant"][i] - st["mu"][i]) / st["sd"][i] for i in (0, 1)]
    return pad_front(Y_ND(Fn, NDT, nadir=st["nadir"], ideal=st["ideal"]),
                     bo.n_bucket)


def gpr_state(model, dtype):
    """(params, train_data) of a GPR: the float32 model's own, or float64
    copies."""
    import copy

    if dtype == torch.float32:
        return model.params, model.train_data
    return (copy.deepcopy(model.params).double(),
            tuple(None if t is None else t.double() for t in model.train_data))


def mobo_state(model, dtype):
    """(form, loop, state) of an MO_BO surrogate in ``dtype``: the float32
    model's own, or float64 copies (the GPRs' train_data cast too)."""
    import copy

    from dgp_tpu_torch.bo.ehvi import _mo_model_state

    kind, loop, state = _mo_model_state(model)
    if dtype == torch.float32:
        return kind, loop, state
    if kind == "two_gpr":
        state = sum((gpr_state(m, dtype) for m in model), ())
    elif kind == "two_dgp":
        state = tuple(copy.deepcopy(p).double() for p in state)
    else:
        state = copy.deepcopy(state).double()
    return kind, loop, state


def mobo_normals(model, gen, rows, samples):
    """Fixed unit normals for one evaluation of ``model`` at ``rows`` rows
    and ``samples`` samples: the GPR pair's two [S, rows] draws, each DGP's
    per-layer [S, rows, 1], the coupled model's (mo_normals)."""
    if not isinstance(model, list):
        return mo_normals(model, gen, rows=rows, S=samples)
    if model[0].name == "gpr":
        return [torch.randn((samples, rows), generator=gen, device=DEVICE)
                for _ in model]
    return [[torch.randn((samples, rows, 1), generator=gen, device=DEVICE)
             for _ in m.params.layers] for m in model]


def compare_mo_bo(tag, bo, st, cap=WITNESS_CAP):
    """EHVI of a trained batch state's surrogate at MOBO_ROWS fixed rows of
    its search box on fixed unit normals (MOBO_EHVI_S samples), by each
    estimator (exact, Gaussian without and with the sample covariance,
    KDE), and, for a constrained state, the loss -(EHVI * PoF) by each: the
    kernels on (launched as ehvi_evaluation reckons) against the plain
    versions (use_kernels off, hold_on_vs_off), and each against the
    float64 twin (hold_to_f64), within TOL_REQUEST of the largest |value|
    plus twice the plain versions' own error against the twin, that term
    at most ``cap`` (MOBO_GPR_CAP for an unconstrained GPR pair's state)."""
    from dgp_tpu_torch.bo import ehvi as tehvi
    from dgp_tpu_torch.config import kernels_scope

    model, model_C = st["model"], st["model_C"]
    rng = np.random.default_rng(23)
    lw, up = (np.broadcast_to(np.asarray(b, dtype=float), (bo.d,))
              for b in (st["lw_n"], st["up_n"]))
    rows = lw + (up - lw) * rng.uniform(size=(MOBO_ROWS, bo.d))
    gen = torch.Generator(device=DEVICE).manual_seed(29)
    normals = mobo_normals(model, gen, MOBO_ROWS, MOBO_EHVI_S)
    YND = mobo_front(bo, st)
    n_con = len(model_C or ())

    def cast(z, dtype):
        return [cast(x, dtype) for x in z] if isinstance(z, list) \
            else z.to(dtype)

    @torch.no_grad()
    def arm(dtype):
        kind, loop, state = mobo_state(model, dtype)
        X = torch.as_tensor(rows, dtype=dtype, device=DEVICE)
        Y0, Y1 = tehvi._front(YND, dtype, DEVICE)
        key = cast(normals, dtype)
        out = [tehvi._ehvi_pure(kind, loop, corr, approx, MOBO_EHVI_S, state,
                                X, Y0, Y1, key).reshape(-1)
               for approx, corr in MOBO_ESTIMATORS]
        if n_con:
            cstates = tuple(gpr_state(m, dtype) for m in model_C)
            zn = torch.as_tensor(st["zero_n"], dtype=dtype, device=DEVICE)
            out += [tehvi._neg_ehvi_pof_loss(
                kind, loop, corr, approx, MOBO_EHVI_S)(
                    X, (state, Y0, Y1, cstates, zn, key))
                    for approx, corr in MOBO_ESTIMATORS]
        return [o.double() for o in out]

    form = mobo_state(model, torch.float32)[0]
    n_est = len(MOBO_ESTIMATORS)
    expect = add_counts(*[ehvi_evaluation(form, 0)] * n_est,
                        *[ehvi_evaluation(form, n_con)] * (n_est if n_con
                                                           else 0))
    before = counts()
    on = arm(torch.float32)
    launched = tuple(a - b for a, b in zip(counts(), before))
    if launched != expect:
        raise AssertionError(f"[mo_bo] {tag} comparison: launches {launched},"
                             f" reckoned {expect}")
    with kernels_scope(False):
        plain = arm(torch.float32)
    with f64_twin():
        ref = arm(torch.float64)
    names = [f"EHVI {approx}{' corr' if corr else ''}"
             for approx, corr in MOBO_ESTIMATORS]
    if n_con:
        names += [f"-(EHVI x PoF) {approx}{' corr' if corr else ''}"
                  for approx, corr in MOBO_ESTIMATORS]
    hold_on_vs_off(f"[mo_bo] {tag}: {MOBO_ROWS} rows at S = {MOBO_EHVI_S}",
                   names, on, plain, ref, cap)
    hold_to_f64(f"[mo_bo] {tag}: EHVI, the kernels vs the plain versions",
                names, ref, on, plain, cap)


def time_ehvi_evaluation(tag, bo, st, gpu, reps=5):
    """Wall ms of one -EHVI evaluation (exact estimator, MOBO_UNCUT's S) of
    a 300-row population in the state's search box: the DE generation's
    call, median of ``reps`` after one warm-up."""
    from dgp_tpu_torch.bo import ehvi as tehvi

    kind, loop, state = mobo_state(st["model"], torch.float32)
    lw, up = (np.broadcast_to(np.asarray(b, dtype=float), (bo.d,))
              for b in (st["lw_n"], st["up_n"]))
    X = torch.as_tensor(lw + (up - lw) * np.random.default_rng(31).uniform(
        size=(MOBO_UNCUT["popsize_DE"], bo.d)), dtype=torch.float32,
        device=DEVICE)
    Y0, Y1 = tehvi._front(mobo_front(bo, st), torch.float32, DEVICE)
    loss = tehvi._neg_ehvi_loss(kind, loop, False, "None", MOBO_UNCUT["S"])
    with torch.no_grad():
        loss(X, (state, Y0, Y1, 7))
        times = [timed(lambda: loss(X, (state, Y0, Y1, 7)))[1]
                 for _ in range(reps)]
    log(f"[mo_bo] {tag}: one EHVI evaluation of {X.shape[0]} rows at S = "
        f"{MOBO_UNCUT['S']}: median {1e3 * float(np.median(times)):.2f} ms "
        f"(min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}) ({gpu})")


def run_mo_bo(gpu):
    """The multi-objective BO driver through the entry points a user calls,
    MO_BO on the card in float32: the default GPR pair on multi_obj_1D_4
    (MOBO_N points, seed MOBO_SEED) cut to MOBO_STEPS Adam steps and
    MOBO_RUN's search, three infills (the second a batch of two, the third
    by suggest() and observe()), then a save and a load, and one more infill
    of the loaded loop bit for bit equal to the same infill of the unsaved
    one (whose hypervolume must then stand above its start); one
    constrained infill on bnh (EHVI x PoF) and one on an all-infeasible srn
    DoE (the PoF-only bootstrap); one infill of the coupled MO-DGP
    (MOBO_COUPLED) and a batch of two of the DGP pair (MOBO_DGP: the lie's
    warm refit). Each loop as mo_drive checks it; then compare_mo_bo at the
    GPR pair's, bnh's, the coupled model's and the DGP pair's batch states,
    the ms of one EHVI evaluation of each form, the idle share of one GPR
    pair infill and one uncut default infill. Returns the path's launches
    (the comparisons', the timings' and the profiled and uncut infills'
    left out)."""
    from dgp_tpu_torch import _build, native
    from dgp_tpu_torch.bo.ehvi import NDC, _ndc_numpy
    from dgp_tpu_torch.bo.mo_bo import MO_BO
    from dgp_tpu_torch.bo.problems import get

    if not native.available():
        raise AssertionError("[mo_bo] the native Pareto sweep did not build")
    rng = np.random.default_rng(3)
    Y = [rng.normal(size=(4_096, 1)), rng.normal(size=(4_096, 1))]
    C = np.where(rng.uniform(size=(4_096, 1)) < 0.2, 1.0, -1.0)
    (nd_native, t_native), (nd_numpy, t_numpy) = (
        timed(lambda: NDC(Y, C)), timed(lambda: _ndc_numpy(Y, C)))
    # the same indices in the same order, objective 1 ascending and
    # descending (_ndc_numpy's descending front is its ascending one reversed)
    if (nd_native != nd_numpy
            or NDC(Y, C, obj1_ascending=False) != nd_numpy[::-1]):
        raise AssertionError("[mo_bo] the native sweep's front differs from "
                             "the numpy loop's on a 4,096-row archive")
    log(f"[mo_bo] native Pareto sweep on a 4,096-row archive: the numpy "
        f"loop's front ({len(nd_numpy)} rows, in its order both ways) in "
        f"{1e3 * t_native:.2f} ms, "
        f"numpy {1e3 * t_numpy:.1f} ms")

    problem = get("multi_obj_1D_4")
    one = dict(problem=problem, DoE_size=MOBO_N, seed=MOBO_SEED,
               device=DEVICE)
    log(f"[mo_bo] multi_obj_1D_4, DoE {MOBO_N}, seed {MOBO_SEED}, float32; "
        f"cut from MO_BO's defaults: GPR Adam 2,000 -> {MOBO_STEPS} steps "
        f"(the constraint GPRs too), DE 300x400 -> {MOBO_RUN['popsize_DE']}x"
        f"{MOBO_RUN['iterations_DE']}, Adam 1,000 -> "
        f"{MOBO_RUN['iterations_adam']}, S 1,000 -> {MOBO_RUN['S']}; the "
        f"coupled schedule (100, 0, 0) -> {MOBO_COUPLED['schedule']}, the "
        f"DGP pair's (100, 0) -> {MOBO_DGP['schedule']}")
    bo = MO_BO(model_dic=MOBO_GPR, **one)
    ask = {k: v for k, v in MOBO_RUN.items() if k != "verbose"}

    def ask_tell():
        X = bo.suggest(**ask)
        bo.observe(X, mo_objectives(problem, X))

    launches = []
    launched, rec = mo_drive("gpr pair", bo, [
        lambda: bo.run(1, **MOBO_RUN),
        lambda: bo.run(1, batch_size=2, **MOBO_RUN), ask_tell], gpu)
    launches.append(launched)
    gpr_state = rec["states"][-1]
    path = os.path.join(_build.BUILD_DIR, "mo_bo_smoke.npz")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    bo.save(path)
    bo2 = MO_BO.load(path, problem, device=DEVICE)
    os.remove(path)
    launches.append(mo_drive("gpr pair, loaded", bo2,
                             [lambda: bo2.run(1, **MOBO_RUN)], gpu)[0])
    launches.append(mo_drive("gpr pair, not saved", bo,
                             [lambda: bo.run(1, **MOBO_RUN)], gpu)[0])
    check_mo_archive("gpr pair, all infills", bo, grows=True)
    if not (np.array_equal(bo.X, bo2.X) and bo.hv_trace == bo2.hv_trace
            and bo._run_key == bo2._run_key):
        raise AssertionError(f"[mo_bo] the loaded loop's infill differs: "
                             f"{bo2.X[-1]} vs {bo.X[-1]}")
    log(f"[mo_bo] save / load: the loaded loop's infill bit for bit the "
        f"unsaved loop's (x {bo.X[-1]})")

    bo_c = MO_BO(problem=get("bnh"), DoE_size=12, seed=MOBO_SEED,
                 model_dic=MOBO_GPR, model_C_dic=MOBO_CON, device=DEVICE)
    launched, rec = mo_drive("bnh, EHVI x PoF", bo_c,
                             [lambda: bo_c.run(1, **MOBO_RUN)], gpu)
    launches.append(launched)
    con_state = rec["states"][-1]
    srn = get("srn")
    X = np.column_stack([rng.uniform(0.95, 1.0, 8), rng.uniform(0.0, 0.05, 8)])
    bo_s = MO_BO(problem=srn, X=X, F=[f[:, None] for f in
                                      mo_objectives(srn, X)],
                 seed=MOBO_SEED, model_dic=MOBO_GPR, model_C_dic=MOBO_CON,
                 device=DEVICE)
    if bo_s.hv_trace != [0.0] or not (bo_s.C[:, 0] > 0).all():
        raise AssertionError("[mo_bo] the srn DoE is not all infeasible")
    launched, rec = mo_drive("srn, all infeasible: the PoF bootstrap", bo_s,
                             [lambda: bo_s.run(1, **MOBO_RUN)], gpu)
    launches.append(launched)
    if [op[2] for op in rec["ops"] if op[0] == "pick"] != [False]:
        raise AssertionError("[mo_bo] the bootstrap pick had a front")
    bo_m = MO_BO(model_dic=MOBO_COUPLED, **one)
    launched, rec = mo_drive("coupled MO-DGP", bo_m,
                             [lambda: bo_m.run(1, **MOBO_RUN)], gpu)
    launches.append(launched)
    mo_state = rec["states"][-1]
    bo_d = MO_BO(model_dic=MOBO_DGP, **one)
    launched, rec = mo_drive("DGP pair", bo_d, [
        lambda: bo_d.run(1, batch_size=2, **MOBO_RUN)], gpu)
    launches.append(launched)
    dgp_state = rec["states"][-1]
    total = add_counts(*launches)
    log(f"[mo_bo] launches on the path {COUNTED}: {total} ({gpu})")

    for tag, loop_, st in (("gpr pair", bo, gpr_state),
                           ("bnh", bo_c, con_state),
                           ("coupled MO-DGP", bo_m, mo_state),
                           ("DGP pair", bo_d, dgp_state)):
        compare_mo_bo(f"{tag} batch state", loop_, st,
                      MOBO_GPR_CAP if tag == "gpr pair" else WITNESS_CAP)
    for tag, loop_, st in (("gpr pair", bo, gpr_state),
                           ("coupled MO-DGP", bo_m, mo_state),
                           ("DGP pair", bo_d, dgp_state)):
        time_ehvi_evaluation(tag, loop_, st, gpu)
    bo_p = MO_BO(model_dic=MOBO_GPR, **one)
    idle_share("one GPR pair infill", lambda: bo_p.run(1, **MOBO_RUN), gpu,
               tag="mo_bo")
    bo_u = MO_BO(**one)
    with recorded_mo_loop(bo_u) as rec:
        _, dt = timed(lambda: bo_u.run(1, **MOBO_UNCUT))
    s = rec["s"]
    log(f"[mo_bo] one uncut default infill (GPR pair, 2,000 Adam steps "
        f"each, DE {MOBO_UNCUT['popsize_DE']}x{MOBO_UNCUT['iterations_DE']}, "
        f"Adam {MOBO_UNCUT['iterations_adam']}, S {MOBO_UNCUT['S']}): "
        f"{dt:.3f} s: surrogate fit {s['fit']:.3f}, DE {s['de']:.3f}, Adam "
        f"{s['adam']:.3f}; hypervolume {bo_u.hv_trace[0]:.5f} -> "
        f"{bo_u.hv_trace[-1]:.5f} ({gpu})")
    return total


# -- phase 12: classification and Student-t regression ------------------------------


def cls_rows():
    """(X, Y, Xt, Yt): the classification configuration's training and
    held-out rows (compat_torch/validate_classification.make_data)."""
    from compat_torch.validate_classification import make_data

    return (*make_data(CLS_N, seed=0), *make_data(CLS_TEST, seed=1))


def cls_model(white=False):
    """The classifier of compat_torch/validate_classification.py on the card
    in float32 (non-whitened unless ``white``)."""
    from compat_torch.validate_classification import classifier

    X, Y, _, _ = cls_rows()
    return classifier(X, Y, white=white, device=DEVICE, dtype=torch.float32)


def t_model():
    """The Student-t model of compat_torch/validate_robust_regression.py on
    the card in float32."""
    from compat_torch import validate_robust_regression as robust

    return robust.model("t", DEVICE, torch.float32)


def nb_model():
    """compat_torch/validate_dgp_regression.py's model (nb_DGP_regression:
    3 non-whitened layers, D = 1, M = 25) on the card in float32."""
    from compat_torch import validate_dgp_regression as regression

    return regression.model(DEVICE, torch.float32)


def cls_expected_counts(path="nonwhite", built=0, losses=0, requests=0,
                        last_layer=0):
    """counts() reckoned for a 2-layer model of ``path`` whose layers share
    one (M, white) group (expected_counts): ``losses`` loss evaluations
    with the gradient of every layer and ``requests`` requests; building it
    runs #7 once per non-whitened layer (its initial q_sqrt). A
    non-whitened natural-gradient evaluation of the last layer's q alone
    (``last_layer``; ng_all=False) runs both layers' #5 and #8 but only the
    last layer's #6: no gradient reaches layer 0's conditional."""
    c = add_counts(expected_counts(path, losses, 2, loss=True),
                   expected_counts(path, requests, 2),
                   launch_vector(c5=2 * last_layer, c6=last_layer,
                                 c8=last_layer))
    return add_counts(c, launch_vector(c7=2 * built * (path == "nonwhite")))


def cls_kuu():
    """[(name, (A, A64))]: the Kuu stacks of the classifier ([2, 30, 30]),
    the Student-t model ([2, 20, 20]) and the nb_DGP_regression model
    ([3, 25, 25]) at their inducing inputs, each one (M, white) group
    factored by #8 per evaluation, with their float64 twins (kuu_twins)."""
    return [(name, kuu_twins(list(m.params.layers),
                             [l.z for l in m.params.layers]))
            for name, m in (("classifier", cls_model()),
                            ("Student-t", t_model()),
                            ("nb_DGP_regression", nb_model()))]


def check_cls_kernels():
    """#5 and #6 at the classification, Student-t and nb_DGP_regression
    models' shapes (CLS_QUADFORM), with and without t1, with the repeat
    and NaN runs; #7 and #8 on their Kuu stacks (cls_kuu), held to their
    float64 twins, L too by the witness rule: the classifier's Kuu (30
    points in 2-D at lengthscale 0.5) puts float32's own L 1.21e-4 of
    scale off its twin (an H100 reading of the library's factor). Returns
    the largest errors [#5, #6, #7, #8]."""
    err = [0.0] * 4
    for seed, (D, Mi, n) in enumerate(CLS_QUADFORM):
        for with_t1 in (False, True):
            err[0] = max(err[0], check_quadform(D, Mi, n, with_t1, 420 + seed))
            err[1] = max(err[1], check_quadform_backward(D, Mi, n, with_t1,
                                                         520 + seed))
    for name, stack in cls_kuu():
        for inverse in (False, True):
            err[2 + inverse] = max(err[2 + inverse], check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack, witness=True))
    return err


def check_launches(tag, what, expect):
    if counts() != expect:
        raise AssertionError(f"[{tag}] {what}: launches {counts()}, reckoned "
                             f"{expect}")


def check_losses(tag, what, losses, n):
    losses = losses.cpu().numpy()
    if losses.shape != (n,) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"[{tag}] {what}: bad losses {losses}")
    if not losses[-5:].mean() < losses[:5].mean():
        raise AssertionError(f"[{tag}] {what}: the loss did not fall: {losses}")
    return losses


def run_cls(gpu):
    """The non-conjugate heads through the entry points a user calls, on
    the card in float32. The classifier (CLS_*): built, optimize_adam for
    CLS_ADAM steps at lr 0.02, then predict and predict_density of the
    held-out rows at CLS_SAMPLES samples (probabilities in [0, 1], the
    accuracy and mean log-density shown); a fresh classifier through
    optimize_nat_adam for CLS_NAT steps (natural gradients on both layers'
    q under the quadrature head: each layer's q_mu moves); the classifier
    whitened, CLS_WHITE_ADAM Adam steps and a request through #1/#2. The
    Student-t model (T_*): optimize_nat_adam for T_NAT steps, a predict of
    its rows. Losses finite and falling; the launches of #1-#8 after each
    step equal to those reckoned (cls_expected_counts). Returns
    (counts(), (classifier, whitened classifier, Student-t model))."""
    zero_counts()
    X, Y, Xt, Yt = cls_rows()
    model, dt = timed(cls_model)
    expect = cls_expected_counts(built=1)
    check_launches("cls", "built", expect)
    losses, dt_adam = timed(lambda: model.optimize_adam(
        iterations=CLS_ADAM, lr=0.02, messages=0))
    losses = check_losses("cls", "optimize_adam", losses, CLS_ADAM)
    expect = add_counts(expect, cls_expected_counts(losses=CLS_ADAM))
    check_launches("cls", "optimize_adam", expect)
    (p, v), dt_p = timed(lambda: model.predict(Xt, CLS_SAMPLES))
    logd, dt_d = timed(lambda: model.predict_density(Xt, Yt, CLS_SAMPLES))
    logd = logd.cpu().numpy()
    if not (p.shape == v.shape == Yt.shape and np.all(p >= 0)
            and np.all(p <= 1) and np.all(v >= 0)
            and logd.shape == Yt.shape and np.all(np.isfinite(logd))):
        raise AssertionError("[cls] requests: bad output")
    expect = add_counts(expect, cls_expected_counts(requests=2))
    check_launches("cls", "requests", expect)
    log(f"[cls] classifier (N {CLS_N}, M 30, hidden width 2, non-whitened, "
        f"Bernoulli, S {CLS_S}, float32): built in {dt:.2f} s; "
        f"optimize_adam {CLS_ADAM} steps (cut from 800) {dt_adam:.2f} s, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; predict and predict_density of "
        f"{CLS_TEST} held-out rows at {CLS_SAMPLES} samples {1e3 * dt_p:.1f} "
        f"and {1e3 * dt_d:.1f} ms (first use): accuracy "
        f"{np.mean((p > 0.5) == (Yt > 0.5)):.3f}, mean log-density "
        f"{logd.mean():.3f}; launches {COUNTED} {counts()} ({gpu})")

    nat = cls_model()
    start = {k: v.clone() for k, v in nat.params.state_dict().items()}
    n1, n2 = CLS_NAT
    losses, dt = timed(lambda: nat.optimize_nat_adam(
        iterations1=n1, iterations2=n2, lr_adam=0.02, lr_gamma=0.1,
        messages=0))
    losses = check_losses("cls", "optimize_nat_adam", losses, n1 + n2)
    still = [k for k in ("layers.0.q_mu", "layers.1.q_mu")
             if torch.equal(nat.params.state_dict()[k], start[k])]
    if still:
        raise AssertionError(f"[cls] natural gradients did not move {still}")
    expect = add_counts(expect, cls_expected_counts(
        built=1, losses=n1 + 2 * n2))
    check_launches("cls", "optimize_nat_adam", expect)
    log(f"[cls] a fresh classifier, optimize_nat_adam {n1} + {n2} steps "
        f"(natural gradients on both layers' q): {dt:.2f} s, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; launches {counts()}")

    white = cls_model(white=True)
    losses, dt = timed(lambda: white.optimize_adam(
        iterations=CLS_WHITE_ADAM, lr=0.02, messages=0))
    losses = check_losses("cls", "whitened optimize_adam", losses,
                          CLS_WHITE_ADAM)
    (p, _), dt_p = timed(lambda: white.predict(Xt, CLS_SAMPLES))
    if not (np.all(p >= 0) and np.all(p <= 1)):
        raise AssertionError("[cls] whitened request: bad output")
    expect = add_counts(expect, cls_expected_counts(
        "stationary", losses=CLS_WHITE_ADAM, requests=1))
    check_launches("cls", "whitened classifier", expect)
    log(f"[cls] the classifier whitened: optimize_adam {CLS_WHITE_ADAM} "
        f"steps {dt:.2f} s, loss {losses[0]:.3f} -> {losses[-1]:.3f}; a "
        f"request {1e3 * dt_p:.1f} ms; launches {counts()}")

    robust, dt = timed(t_model)
    n1, n2 = T_NAT
    losses, dt_nat = timed(lambda: robust.optimize_nat_adam(
        iterations1=n1, iterations2=n2, lr_adam=0.02, lr_gamma=0.05,
        ng_all=False, messages=0))
    losses = check_losses("cls", "Student-t optimize_nat_adam", losses,
                          n1 + n2)
    rows = robust.data[0].cpu().numpy()
    (mean, var), dt_p = timed(lambda: robust.predict(rows, CLS_SAMPLES))
    if not (mean.shape == var.shape == (T_N, 1) and np.all(np.isfinite(mean))
            and np.all(var > 0)):
        raise AssertionError("[cls] Student-t predict: bad output")
    expect = add_counts(expect, cls_expected_counts(
        built=1, losses=n1 + n2, requests=1, last_layer=n2))
    check_launches("cls", "Student-t model", expect)
    log(f"[cls] Student-t model (N {T_N}, M 20, hidden width 1, S {T_S}, "
        f"scale 0.1, df 3, float32): built in {dt:.2f} s; optimize_nat_adam "
        f"{n1} + {n2} steps (cut from 300 + 700) {dt_nat:.2f} s, loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; a predict of its {T_N} rows "
        f"at {CLS_SAMPLES} samples {1e3 * dt_p:.1f} ms; launches {COUNTED} "
        f"{counts()}, reckoned {expect} ({gpu})")
    return counts(), (model, white, robust)


def compare_head(tag, model, rows, S, samples, seed, vector=False):
    """compare_on_off for a 2-layer DGP with a quadrature head: a request
    of ``rows`` at ``samples`` samples (predict_y, moment-matched) and a
    loss over its training rows at S samples, each on fixed unit normals,
    the kernels on and off (the gradients by the witness rule, as one
    vector with ``vector``) and the request against float64; every layer's
    z and the kernel variances' gradients nonzero."""
    from dgp_tpu_torch.models import dgp as tdgp

    X, Y = model.data
    layers = model.params.layers
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    zr = [torch.randn((samples, len(rows), l.num_outputs), generator=gen,
                      device=DEVICE) for l in layers]
    zl = [torch.randn((S, X.shape[0], l.num_outputs), generator=gen,
                      device=DEVICE) for l in layers]
    path = path_of(model)
    compare_on_off(
        tag, model, rows,
        lambda params, Xr, dtype: tdgp.predict_y(
            params, Xr, samples, zs=[z.to(dtype) for z in zr]),
        lambda params, dtype: tdgp.elbo(
            params, X.to(dtype), Y.to(dtype), S,
            zs=[z.to(dtype) for z in zl]),
        expected_counts(path, 1, 2), expected_counts(path, 1, 2, loss=True),
        [f"layers.{i}.{name}" for i in range(2)
         for name in ("z", "kernel.variance_raw")], gradient_witness=True,
        vector=vector)


def compare_cls(model, white, robust):
    """compare_head for the trained classifier (non-whitened: #5/#6; and
    whitened: #1/#2, under the quadrature head) on the held-out rows at
    CLS_SAMPLES samples, and for the trained Student-t model on its rows,
    whose gradients are held as one vector: at its trained state layer 0's
    kernel gradients nearly vanish (|g| ~0.6 where layer 1's z reads ~100)
    and float32 alone puts them 4e-2 to 4e-1 off float64 (an H100 reading
    of the plain versions), beyond any per-entry witness's cap."""
    Xt = cls_rows()[2]
    compare_head("cls", model, Xt, CLS_S, CLS_SAMPLES, 13)
    compare_head("cls whitened", white, Xt, CLS_S, CLS_SAMPLES, 14)
    compare_head("cls Student-t", robust, robust.data[0].cpu().numpy(), T_S,
                 CLS_SAMPLES, 15, vector=True)


def time_cls(models, gpu):
    """time_staged for the classifier (non-whitened and whitened) and the
    Student-t model: ms per loss-and-gradient and per request of the
    held-out rows (its own rows) at CLS_SAMPLES samples, and the device
    idle share over three Adam steps."""
    model, white, robust = models
    Xt = cls_rows()[2]
    for label, m, rows in (
            (f"cls (classifier, N {CLS_N}, S {CLS_S})", model, Xt),
            (f"cls-whitened (classifier, N {CLS_N}, S {CLS_S})", white, Xt),
            (f"Student-t (N {T_N}, S {T_S})", robust,
             robust.data[0].cpu().numpy())):
        time_staged(label, m, rows, gpu, samples=CLS_SAMPLES,
                    predict=lambda m=m, rows=rows: m.predict(rows, CLS_SAMPLES))


# -- phase 13: data parallelism over torch.distributed ------------------------

PAR_ADAM, PAR_NAT = 10, (3, 5)   # the whitened mesh model's steps (world 1)
PAR_CHUNK = 25_000               # the chunked request's chunks
PAR_TOL = 1e-5                   # sharded vs unsharded, of scale: the
                                 # float32 reduction order
PAR_GPR_N = 128                  # the exact GPR's training rows (#7's plan)
PAR_STEPS = 2                    # Adam steps per rank at world size 2
PAR_ROUNDS = 3                   # timing rounds, sharded and not in turns
PAR_TIMED_STEPS = 5              # Adam steps per timing round


@contextlib.contextmanager
def patched_randn(draw):
    """torch.randn is draw(the real torch.randn, *args, **kwargs) while the
    scope lasts: every unit normal of the port's models goes through it."""
    real = torch.randn
    torch.randn = lambda *args, **kwargs: draw(real, *args, **kwargs)
    try:
        yield
    finally:
        torch.randn = real


def recorded_draws(fn):
    """fn()'s result and every unit normal it drew, in order."""
    draws = []

    def record(real, *args, **kwargs):
        z = real(*args, **kwargs)
        draws.append(z.clone())
        return z

    with patched_randn(record):
        out = fn()
    return out, draws


def zero_normals():
    """A scope in which every unit normal torch.randn draws is 0 (a
    propagation then follows its means: no Monte-Carlo noise)."""
    return patched_randn(lambda real, *shape, generator=None, **kw:
                         torch.zeros(*shape, **kw))


def rank_rows(z, axis, block, n_blocks):
    """This block's rows of ``z`` along ``axis``, the rows zero-padded to a
    multiple of the blocks first, as pad_shard_batch pads the data."""
    n = z.shape[axis]
    b = -(-n // n_blocks)
    shape = list(z.shape)
    shape[axis] = b * n_blocks - n
    return torch.cat([z, z.new_zeros(shape)], dim=axis).narrow(
        axis, block * b, b)


def rank_share(draws, samples, block, n_blocks):
    """This rank's share of one unsharded evaluation's draws: a layer's
    [S, N, D] draw and MO's [N, 1] its rows' block; the augmented inducing
    inputs' [50, M, D] draws whole."""
    out = []
    for z in draws:
        if z.dim() == 3 and z.shape[0] == samples:
            z = rank_rows(z, 1, block, n_blocks)
        elif z.dim() == 2:
            z = rank_rows(z, 0, block, n_blocks)
        out.append(z)
    return out


def par_elbo(kind):
    """elbo_of(model, gen=None, noise=None) for a family (the DGP's fixed
    normals are its zs)."""
    from dgp_tpu_torch.models import dgp, mf_dgp, mf_dgp_em, mo_dgp

    return {
        "dgp": lambda m, gen=None, noise=None: dgp.elbo(
            m.params, *m.data, m.num_samples, gen, zs=noise),
        "mf": lambda m, gen=None, noise=None: mf_dgp.elbo(
            m.params, m._X, m._Y, m.num_samples, gen, noise=noise),
        "em": lambda m, gen=None, noise=None: mf_dgp_em.elbo(
            m.params, m._X, m._Y, m._X_red, m.num_samples, gen, noise=noise),
        "mo": lambda m, gen=None, noise=None: mo_dgp.elbo(
            m.params, m._X, m._Y, m.num_samples, gen, loop=m.loop,
            noise=noise)}[kind]


def f64_model(model):
    """A float64 copy of what par_elbo reads of a wrapper: its parameters,
    its data and its sizes (the same function under f64_twin)."""
    import copy
    import types

    twin = types.SimpleNamespace(params=copy.deepcopy(model.params).double(),
                                 num_samples=model.num_samples,
                                 loop=getattr(model, "loop", None))
    for attr in ("data", "_X", "_Y", "_X_red"):
        if hasattr(model, attr):
            setattr(twin, attr, [t.double() for t in getattr(model, attr)])
    return twin


def hold_sharded(tag, kind, single, sharded, expect):
    """One sharded loss-and-gradient of ``sharded`` (a model on a mesh, this
    rank handed its share of one draw) against the unsharded one of
    ``single`` (the same parameters, the whole draw): the loss and each
    gradient within PAR_TOL of its scale plus twice the unsharded float32
    gradient's own error against its float64 twin on the same draw (the
    witness rule, that term at most WITNESS_CAP): a different order of the
    sums over rows moves a gradient whose terms cancel by as much as
    float32 itself is off. The sharded evaluation's launches (zeroed
    before it, read after) must be ``expect``. Returns (worst error, the
    reduced gradient, the launches)."""
    from dgp_tpu_torch.parallel.mesh import block_of

    elbo_of = par_elbo(kind)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    with torch.no_grad():
        _, draws = recorded_draws(lambda: elbo_of(single, gen=gen))
    want = -elbo_of(single, noise=draws)
    names = [n for n, _ in single.params.named_parameters()]
    want_g = torch.autograd.grad(want, list(single.params.parameters()),
                                 allow_unused=True)
    twin = f64_model(single)
    with f64_twin():
        ref_g = torch.autograd.grad(
            -elbo_of(twin, noise=[z.double() for z in draws]),
            list(twin.params.parameters()), allow_unused=True)
    loss, batch = sharded._loss_spec()
    block, n_blocks = block_of(sharded.mesh)
    share = rank_share(draws, single.num_samples, block, n_blocks)
    zero_counts()
    got = loss(sharded.params, sharded.generator, batch,
               **{"zs" if kind == "dgp" else "noise": share})
    got_g = loss.reduce_grads(torch.autograd.grad(
        got, list(sharded.params.parameters()), allow_unused=True))
    sync()
    launched = counts()
    if launched != expect:
        raise AssertionError(f"[parallel] {tag}: launches {launched}, "
                             f"expected {expect}")
    worst = abs(float((got - want).detach())) / abs(float(want.detach()))
    report, failed = [f"loss {worst:.2e}"], worst > PAR_TOL
    for name, a, b, r in zip(names, got_g, want_g, ref_g):
        if b is None or not float(b.abs().max()):
            continue
        err = float((a - b).abs().max()) / float(b.abs().max())
        own = float((b.double() - r).abs().max()) / float(r.abs().max())
        limit = PAR_TOL + min(2 * own, WITNESS_CAP)
        worst = max(worst, err)
        failed |= not err <= limit
        report.append(f"{name} {err:.2e} (limit {limit:.2e})")
    log(f"[parallel] {tag}: sharded vs unsharded on one draw, err / scale "
        f"(limit {PAR_TOL} + 2x float32's own error): {', '.join(report)}")
    if failed:
        raise AssertionError(f"[parallel] {tag}: sharded vs unsharded beyond "
                             f"the limits")
    return worst, [g.cpu().numpy() for g in got_g if g is not None], launched


def one_layer_model(mesh=None):
    """bench.py's data and inducing points with one whitened RBF layer
    (D = 1): its request does not depend on the draws."""
    from dgp_tpu_torch.models.dgp import DGP
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(N_TRAIN, DIN))
    Y = np.sin(3 * X[:, :1]) + 0.05 * rng.normal(size=(N_TRAIN, 1))
    Z = X[rng.choice(N_TRAIN, M, replace=False)].copy()
    model = DGP(X, Y, Z, [K.RBF.create(variance=1.0, lengthscales=[1.0] * DIN,
                                       dtype=torch.float32, device=DEVICE)],
                [], num_samples=S, white=True, mesh=mesh, device=DEVICE,
                dtype=torch.float32)
    perturb(model, np.random.default_rng(8))
    return model


def gpr_model():
    """An exact GPR on PAR_GPR_N rows in DIN dimensions, float32 on the card
    (its Gram factored by #7)."""
    from dgp_tpu_torch.models.gpr import GPR
    from dgp_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, size=(PAR_GPR_N, DIN))
    Y = np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2
    return GPR((X, Y), K.RBF.create(lengthscales=[0.7] * DIN,
                                    dtype=torch.float32, device=DEVICE),
               noise_variance=1e-3, device=DEVICE, dtype=torch.float32)


def hold_request(tag, got, want):
    """A deterministic request, sharded against unsharded: within PAR_TOL
    of scale."""
    worst = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"[parallel] {tag}: bad sharded output")
        worst = max(worst, float((a - b).abs().max()) / float(b.abs().max()))
    if not worst <= PAR_TOL:
        raise AssertionError(f"[parallel] {tag}: sharded vs unsharded {worst:.2e}")
    return worst


def moment_band(tag, got, want):
    """Two requests of a 2-layer model on different streams: per row, the
    squared difference of the sample means over its Monte-Carlo variance
    (the two requests' sample variances / S) averages about 1; a row served
    from another row's block would push it far past 2."""
    (gm, gv), (wm, wv) = got, want
    if gm.shape != wm.shape or not (torch.isfinite(gm).all()
                                    and (gv > 0).all()):
        raise AssertionError(f"[parallel] {tag}: bad sharded output")
    S_ = gm.shape[0]
    z2 = ((gm.mean(0) - wm.mean(0)) ** 2
          / ((gm.var(0) + wm.var(0)) / S_ + 1e-30))
    score = float(z2.mean())
    if not 0.5 <= score <= 2.0:
        raise AssertionError(f"[parallel] {tag}: mean squared z {score:.3f}")
    return score


def timed_rounds(fns, rounds=PAR_ROUNDS):
    """{name: [wall ms per call of each round]}, the functions called in
    turns, each round after a warm-up call."""
    out = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            _, dt = timed(fn)
            out[name].append(1e3 * dt)
    return out


def par_family(kind, mesh):
    """(unsharded model, model on the mesh, request rows, expected
    launches of one loss-and-gradient, of one request) for MF, EM or
    MO."""
    build, rows, reckon = {
        "mf": (mf_model, mf_request_rows, mf_expected_counts),
        "em": (em_model, em_request_rows, em_expected_counts),
        "mo": (mo_model, mo_request_rows, mo_expected_counts)}[kind]
    single, sharded = build(), build(mesh=mesh)
    for m in (single, sharded):
        m._init_variational()
    return (single, sharded, rows(), reckon(losses=1), reckon(requests=1))


def run_parallel_ws1(gpu):
    """World size 1 under NCCL in this process: bench.py's whitened model
    trained on a mesh (PAR_ADAM Adam, PAR_NAT Adam + natural-gradient
    steps) and serving a 100,000-row request whole and in chunks; the
    non-whitened model, the exact GPR, MF, EM and MO each through one
    sharded loss-and-gradient and a request. Returns the launches of the
    sharded path (the unsharded twins' evaluations not counted)."""
    from examples_torch.serving import process_group

    with process_group(DEVICE) as mesh:
        return parallel_ws1_body(gpu, mesh)


def parallel_ws1_body(gpu, mesh):
    import torch.distributed as dist

    launched = (0,) * 11
    add = lambda c: tuple(a + b for a, b in zip(launched, c))
    log(f"[parallel] world size 1 ({dist.get_backend()}): mesh {mesh}")

    model = training_model(mesh=mesh)
    launched = add(train(model, gpu, PAR_ADAM, PAR_NAT))
    log(f"[parallel] whitened model on the mesh trained through the sharded "
        f"loss: launches {launched}")
    rng = np.random.default_rng(6)
    Xr = rng.uniform(0, 1, size=(N_REQUEST, DIN))
    for chunk in (None, PAR_CHUNK):
        zero_counts()
        with torch.no_grad():
            (mean, var), dt = timed(lambda: model.predict_y_sharded(
                Xr, S, chunk_size=chunk))
        n_eval = 1 if chunk is None else N_REQUEST // chunk
        expect = expected_counts("stationary", n_eval, 2)
        if counts() != expect or mean.shape != (S, N_REQUEST, 1):
            raise AssertionError(f"[parallel] request (chunk {chunk}): "
                                 f"launches {counts()}, expected {expect}")
        launched = add(counts())
        log(f"[parallel] predict_y_sharded {N_REQUEST} rows, chunk {chunk}: "
            f"{1e3 * dt:.2f} ms (first call), launches {counts()}")
    with torch.no_grad():
        band = moment_band("2-layer request", (mean, var),
                           model.predict_y(Xr, S))
    log(f"[parallel] 2-layer sharded request vs unsharded: mean z^2 "
        f"{band:.3f} (band 0.5-2)")

    errs = {}
    for white, tag in ((True, "whitened"), (False, "non-whitened")):
        single, sharded = training_model(white=white), training_model(
            white=white, mesh=mesh)
        for m in (single, sharded):
            perturb(m, np.random.default_rng(3))
        path = "stationary" if white else "nonwhite"
        errs[tag], _, c = hold_sharded(tag, "dgp", single, sharded,
                                       expected_counts(path, 1, 2, loss=True))
        launched = add(c)
        if not white:
            zero_counts()
            with torch.no_grad():
                out = sharded.predict_y_sharded(Xr, S)
            if counts() != expected_counts(path, 1, 2):
                raise AssertionError(f"[parallel] non-whitened request: "
                                     f"launches {counts()}")
            launched = add(counts())
    one, one_mesh = one_layer_model(), one_layer_model(mesh)
    zero_counts()
    with torch.no_grad():
        got = one_mesh.predict_y_sharded(Xr, S)
        launched = add(counts())
        errs["1-layer request"] = hold_request(
            "1-layer request", got, one.predict_y(Xr, S))
    gpr = gpr_model()
    zero_counts()
    with torch.no_grad():
        got = gpr.predict_y_sharded(Xr, mesh)
        if counts() != (0,) * 6 + (1,) + (0,) * 4:
            raise AssertionError(f"[parallel] GPR request: launches {counts()}")
        launched = add(counts())
        errs["GPR request"] = hold_request("GPR request", got,
                                           gpr.predict_y(Xr))
    for kind in ("mf", "em", "mo"):
        single, sharded, rows, expect_loss, expect_request = par_family(
            kind, mesh)
        errs[kind], _, c = hold_sharded(kind, kind, single, sharded,
                                        expect_loss)
        launched = add(c)
        zero_counts()
        with torch.no_grad():
            mean, var = sharded.predict_y_sharded(rows, sharded.num_samples)
        if counts() != expect_request or not torch.isfinite(mean).all():
            raise AssertionError(f"[parallel] {kind} request: launches "
                                 f"{counts()}, expected {expect_request}")
        launched = add(counts())
    log(f"[parallel] sharded vs unsharded on one draw, err / scale (tol "
        f"{PAR_TOL}): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    single = training_model()
    times = timed_rounds({
        "adam": lambda: single.optimize_adam(
            iterations=PAR_TIMED_STEPS, messages=0, shrink_inner=False),
        "adam_sharded": lambda: model.optimize_adam(
            iterations=PAR_TIMED_STEPS, messages=0, shrink_inner=False),
        "request": lambda: single.predict_y(Xr, S),
        "request_sharded": lambda: model.predict_y_sharded(Xr, S)})
    per_step = {k: [t / PAR_TIMED_STEPS for t in v] if k.startswith("adam")
                else v for k, v in times.items()}
    log(f"[parallel] world size 1 ms per Adam step (whitened, N {N_TRAIN}) "
        f"and per {N_REQUEST}-row request, {PAR_ROUNDS} rounds in turns: "
        + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                    for k, v in per_step.items()) + f" ({gpu})")
    for label, m in (("unsharded", single), ("sharded, world size 1", model)):
        profile_run(f"three {label} whitened Adam steps", lambda m=m:
                    m.optimize_adam(iterations=3, messages=0,
                                    shrink_inner=False), gpu)
    return launched


def parallel_rank(rank, world, port, folder):
    """One rank of the world-size-2 run (both ranks on cuda:0, gloo): the
    whitened and non-whitened losses-and-gradients and MF's against the
    unsharded ones on one draw, a 1-layer request against the unsharded
    one, PAR_STEPS Adam steps, and timed Adam steps and requests. Saves
    its results for the parent."""
    import pickle

    import torch.distributed as dist

    from dgp_tpu_torch import _build
    from dgp_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no CUDA device")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        _build.build()   # the parent built the libraries: this loads them
        out = parallel_rank_body(rank, make_mesh())
    finally:
        dist.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def parallel_rank_body(rank, mesh):
    """parallel_rank's work on ``mesh``; returns its results."""
    out = {"launched": (0,) * 11, "errs": {}}
    add = lambda c: tuple(a + b for a, b in zip(out["launched"], c))
    grads = {}
    for white, tag in ((True, "whitened"), (False, "non-whitened")):
        single, sharded = training_model(white=white), training_model(
            white=white, mesh=mesh)
        for m in (single, sharded):
            perturb(m, np.random.default_rng(3))
        path = "stationary" if white else "nonwhite"
        out["errs"][tag], grads[tag], c = hold_sharded(
            tag, "dgp", single, sharded,
            expected_counts(path, 1, 2, loss=True))
        out["launched"] = add(c)
    single, sharded, _, expect_loss, _ = par_family("mf", mesh)
    out["errs"]["mf"], grads["mf"], c = hold_sharded(
        "mf", "mf", single, sharded, expect_loss)
    out["launched"] = add(c)
    rng = np.random.default_rng(6)
    Xr = rng.uniform(0, 1, size=(N_REQUEST, DIN))
    one, one_mesh = one_layer_model(), one_layer_model(mesh)
    zero_counts()
    with torch.no_grad():
        got = one_mesh.predict_y_sharded(Xr, S)
        out["launched"] = add(counts())
        out["errs"]["1-layer request"] = hold_request(
            "1-layer request", got, one.predict_y(Xr, S))
    model = training_model(mesh=mesh)
    zero_counts()
    model.optimize_adam(iterations=PAR_STEPS, messages=0)
    sync()
    if counts() != expected_counts("stationary", PAR_STEPS, 2, loss=True):
        raise AssertionError(f"rank {rank}: Adam launches {counts()}")
    out["launched"] = add(counts())
    out["params"] = {k: v.cpu().numpy().copy()
                     for k, v in model.params.state_dict().items()}
    out["grads"] = grads
    times = timed_rounds({
        "adam_sharded": lambda: model.optimize_adam(
            iterations=PAR_TIMED_STEPS, messages=0, shrink_inner=False),
        "request_sharded": lambda: model.predict_y_sharded(Xr, S)})
    out["times"] = {k: [t / PAR_TIMED_STEPS for t in v]
                    if k.startswith("adam") else v
                    for k, v in times.items()}
    return out


def run_parallel_ws2(gpu, world=2):
    """World size 2 on the one card: two spawned ranks on cuda:0 under gloo
    (NCCL refuses two ranks on one GPU), started after this process built
    the kernels (the ranks only load them). Checks their results: each
    rank's errors within PAR_TOL, its launches as reckoned from its rows,
    and both ranks' gradients and parameters after the steps bit-equal.
    Returns the ranks' launches, summed."""
    import pickle

    import torch.multiprocessing as mp

    from examples_torch.serving import free_port

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "parallel")
    os.makedirs(folder, exist_ok=True)
    for r in range(world):
        if os.path.exists(os.path.join(folder, f"rank{r}.pkl")):
            os.remove(os.path.join(folder, f"rank{r}.pkl"))
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=parallel_rank, args=(r, world, port, folder))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if [p.exitcode for p in procs] != [0] * world:
        raise AssertionError(f"[parallel] world size {world}: rank exit codes "
                             f"{[p.exitcode for p in procs]}")
    outs = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    for r, o in enumerate(outs[1:], 1):
        for tag in o["grads"]:
            if not all(np.array_equal(a, b) for a, b in
                       zip(o["grads"][tag], outs[0]["grads"][tag])):
                raise AssertionError(f"[parallel] rank {r}'s {tag} gradient "
                                     f"differs from rank 0's")
        if not all(np.array_equal(o["params"][k], outs[0]["params"][k])
                   for k in o["params"]):
            raise AssertionError(f"[parallel] rank {r}'s parameters after "
                                 f"{PAR_STEPS} Adam steps differ from rank 0's")
    for r, o in enumerate(outs):
        log(f"[parallel] world size {world} (gloo, both ranks on cuda:0), "
            f"rank {r}: sharded vs unsharded err / scale (tol {PAR_TOL}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in o["errs"].items())
            + f"; launches {o['launched']}")
        log(f"[parallel] world size {world}, rank {r}, two processes sharing "
            f"one card (not scaling): ms per Adam step and per {N_REQUEST}-row "
            f"request, {PAR_ROUNDS} rounds: "
            + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                        for k, v in o["times"].items()) + f" ({gpu})")
    log(f"[parallel] world size {world}: gradients and the parameters after "
        f"{PAR_STEPS} Adam steps bit-equal across ranks; "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    return tuple(sum(o["launched"][k] for o in outs) for k in range(11))


def run_parallel(gpu):
    """The parallel phase: world size 1 (NCCL) here, then world size 2
    (gloo) in two ranks; returns the launches of both."""
    t0 = time.perf_counter()
    ws1 = run_parallel_ws1(gpu)
    ws2 = run_parallel_ws2(gpu)
    log(f"[parallel] phase: {time.perf_counter() - t0:.1f} s")
    return tuple(a + b for a, b in zip(ws1, ws2))


# -- phase 14: the examples and the README's production recipes ------------------
# examples_torch/ at budgets cut from the examples' (steps, infills, DE
# sizes; the widths, samples and rows as the examples have them). The
# quickstart: nb_DGP_regression's 3-layer DGP (M = 25, D = 1) 20 + 20
# natural-gradient steps (200 + 400), the Park MF-DGP 10 / 10 / 20 (100 /
# 100 / 200), the constrained GPR SO_BO 2 infills of 100 training steps and
# DE 20 x 10 (3, 200, 50 x 50), the MO-DGP 10 steps (100; restarts "auto"
# as the example) and EHVI at S 500; serving: 30 Adam steps (150);
# ask/tell: 2 rounds of 3 at 100 steps, DE 20 x 10 (4, 500, 60 x 80), the
# asynchronous part at 100 steps, DE 20 x 10 (300, 40 x 60);
# classification 50 Adam steps (800); MF_BO: the AR(1) loop 2 infills (6)
# of 8 starts x 100 steps (2,000), DE 20 x 10 (60 x 60), the PoF loop 1
# infill (3) with its constraint GPR at 100 steps (2,000), the EM loop 1
# infill (2) at schedule (10, 5, 5) ((50, 20, 50)); MO_BO: the GPR pair 1
# infill (4) at 100 Adam steps (2,000), DE 20 x 10, S 200 (60 x 60), the
# coupled MO-DGP 1 infill at schedule (10, 0, 0) ((100, 0, 0)), restarts=1
# (the example: "auto"), DE 20 x 10 (30 x 30).
EX_DGP, EX_MF, EX_MO, EX_SERVE, EX_CLS = (20, 20), (10, 10, 20), 10, 30, 50
EX_TRAIN, EX_DE = 100, dict(popsize_DE=20, iterations_DE=10)
EX_AR1 = {"type": "ar1", "n_starts": 8, "iterations": 100}
EX_GPR_PAIR = {"type": "independent", "num_layers": 0, "kernels": "rbf",
               "iterations": 100}
# recipe (a) at full size: benchmarks/large_scale.py's N = 1,000,000 rows,
# B = 10,000, S = 10; optimize_nat_adam (1,000, 5,000) cut to (10, 5) at
# M = 128 and (10, 5) at M = 256; EX_TIMED Adam steps timed in 3 rounds;
# recipe (b) 4 natural-gradient steps with a checkpoint after 2, the fresh
# model 2 more; recipe (c) 2 + 1 infills of EX_TRAIN steps, DE EX_DE
EX_N, EX_B, EX_LARGE_ITERS, EX_TIMED = 1_000_000, 10_000, (10, 5), 10
# the examples' quadform shapes (D, M, n): the quickstart DGP's training
# (10 samples x 50 rows) and request (100 x 50), serving's training (5 x
# 200), its whole request (50 x 1,003) and a chunk (50 x 256), the
# quickstart MO-DGP's losses (5 x 10) and EHVI (500 x 2)
EX_QUADFORM = [(1, 25, 500), (1, 25, 5_000), (1, 16, 1_000),
               (1, 16, 50_150), (1, 16, 12_800), (1, 10, 50), (1, 10, 1_000)]


def check_examples_kernels():
    """#5 and #6 at the examples' own shapes (EX_QUADFORM), with and
    without t1, with the repeat and NaN runs; #7 and #8 on the quickstart
    DGP's Kuu stack ([3, 25, 25]) and serving's ([2, 16, 16]) against their
    float64 twins (the witness rule for L too). Returns the largest errors
    [#5, #6, #7, #8]."""
    from examples_torch import quickstart, serving

    err = [0.0] * 4
    for seed, (D, Mi, n) in enumerate(EX_QUADFORM):
        for with_t1 in (False, True):
            err[0] = max(err[0], check_quadform(D, Mi, n, with_t1, 620 + seed))
            err[1] = max(err[1], check_quadform_backward(D, Mi, n, with_t1,
                                                         720 + seed))
    for name, model in (("quickstart DGP", quickstart.regression_model),
                        ("serving", serving.model)):
        m = model(device=DEVICE, dtype=torch.float32)
        stack = kuu_twins(list(m.params.layers),
                          [l.z for l in m.params.layers])
        for inverse in (False, True):
            err[2 + inverse] = max(err[2 + inverse], check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack, witness=True))
    return err


@contextlib.contextmanager
def recorded_so_bo():
    """Reckon #7 for SO_BO loops on exact GPR surrogates while the scope
    lasts (SO_BO's methods wrapped on the class, so loops built or loaded
    inside count too): a GPR's training step factors its Gram once, a
    believer mean once, and each pick evaluates the criterion on the
    objective GPR and on every constraint GPR (1 + generations) times for
    DE and (steps + 1) times for Adam. Yields {"c7": the count}."""
    from dgp_tpu_torch.bo.so_bo import SO_BO

    rec = {"c7": 0, "s": {}}
    calls = []
    propose, train, fantasy, next_key = (
        SO_BO._propose, SO_BO.train_model, SO_BO._fantasy_mean,
        SO_BO._next_run_key)

    def train_model(self, model, iteration=3000):
        if model.name != "gpr":
            raise AssertionError("recorded_so_bo reckons GPR surrogates only")
        rec["c7"] += iteration
        return train(self, model, iteration)

    def fantasy_mean(self, model, x_n):
        rec["c7"] += 1
        return fantasy(self, model, x_n)

    def proposing(self, *args, **kwargs):
        calls.append(kwargs)
        try:
            return propose(self, *args, **kwargs)
        finally:
            calls.pop()

    def pick(self):
        kw = calls[-1]
        method = kw.get("IC_method", "DE+Adam")
        evaluations = ((1 + kw.get("iterations_DE", 400)) * ("DE" in method)
                       + (kw.get("iterations_adam", 1000) + 1)
                       * ("Adam" in method))
        n_con = self.C.shape[1] if self.problem.constraint else 0
        rec["c7"] += evaluations * (1 + n_con)
        return next_key(self)

    with wrap_methods(rec, [
            (SO_BO, "train_model", train_model, None),
            (SO_BO, "_fantasy_mean", fantasy_mean, None),
            (SO_BO, "_propose", proposing, None),
            (SO_BO, "_next_run_key", pick, None)]):
        yield rec


@contextlib.contextmanager
def recorded_loops(cls, recorder):
    """While the scope lasts, every ``cls`` loop built or loaded is recorded
    by ``recorder`` (recorded_loop, recorded_mo_loop) from its construction
    on. Yields the [(loop, record)] list, in construction order."""
    loops, scopes = [], []
    init = cls.__init__

    def recording(self, *args, **kwargs):
        init(self, *args, **kwargs)
        scopes.append(recorder(self))
        loops.append((self, scopes[-1].__enter__()))

    cls.__init__ = recording
    try:
        yield loops
    finally:
        cls.__init__ = init
        for scope in reversed(scopes):
            scope.__exit__(None, None, None)


@contextlib.contextmanager
def checkpoint_snapshots():
    """Record, in the yielded list, a copy of the parameters each in-phase
    checkpoint writes while the scope lasts (training.make_checkpoint_fn
    wrapped)."""
    from dgp_tpu_torch.models import training

    snapshots = []
    make = training.make_checkpoint_fn

    def recording(path):
        save = make(path)

        def fn(params, done):
            save(params, done)
            snapshots.append((done, {k: v.clone() for k, v in
                                     params.state_dict().items()}))
        return fn

    training.make_checkpoint_fn = recording
    try:
        yield snapshots
    finally:
        training.make_checkpoint_fn = make


def ex_step(name, fn, expect, totals):
    """Run one section of the examples phase with its prints captured, add
    ``expect`` to the phase's reckoned launches and check them. Returns
    (fn's result, seconds)."""
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        out, dt = timed(fn)
    totals[0] = add_counts(totals[0], expect(out) if callable(expect)
                           else expect)
    check_launches("examples", name, totals[0])
    return out, dt


def check_loop_trace(tag, trace, floor=-math.inf):
    trace = np.asarray(trace, dtype=float).ravel()
    if not (np.all(np.isfinite(trace)) and np.all(np.diff(trace) <= 1e-12)
            and trace.min() >= floor):
        raise AssertionError(f"[examples] {tag}: bad best trace {trace}")


def run_examples(gpu):
    """The examples of examples_torch/ and the README's recipes through the
    entry points a user calls, on the card in float32, at the EX_* budgets:
    every section of quickstart, serving, ask_tell, classification, mf_bo
    and mo_bo, and recipes (a) at full N and B (M = 128 through #1/#2, and
    M = 256, where every kernel's plan refuses the shapes: no launch), (b)
    and (c). Checks the examples' own asserts, every loss finite and
    falling, serving's whole and chunked requests equal within 1e-6 of
    scale on zero normals, the checkpoint reloaded bit for bit, the resumed
    SO_BO equal to the uninterrupted one, and the launches of #1-#8 after
    each section as reckoned. Times recipe (a)'s Adam steps at both M, with
    the device's idle share. Returns counts()."""
    from examples_torch import (ask_tell, classification, mf_bo, mo_bo,
                                quickstart, recipes, serving)

    t_phase = time.perf_counter()
    f32 = dict(device=DEVICE, dtype=torch.float32)
    zero_counts()
    totals = [launch_vector()]
    secs = {}
    nonwhite = lambda n, layers: expected_counts("nonwhite", n, layers,  # noqa: E731
                                                 loss=True)

    # quickstart -------------------------------------------------------------
    # the DGP: built (#7 per non-whitened layer), the initial ELBO and the
    # predict (as requests), n1 + n2 Adam losses, and n2 natural-gradient
    # evaluations of the last layer's q alone (ng_all=False: every layer's
    # #5 and the #8, the last layer's #6 only)
    n1, n2 = EX_DGP
    (model, losses, rmse), secs["quickstart DGP"] = ex_step(
        "quickstart DGP regression",
        lambda: quickstart.dgp_regression(iterations=EX_DGP, **f32),
        add_counts(launch_vector(c7=3), expected_counts("nonwhite", 2, 3),
                   nonwhite(n1 + n2, 3), launch_vector(c5=3 * n2, c6=n2,
                                                       c8=n2)), totals)
    check_losses("examples", "quickstart DGP", losses, n1 + n2)
    a, b, c = EX_MF
    (model, losses, metrics), secs["quickstart MF-DGP"] = ex_step(
        "quickstart MF-DGP",
        lambda: quickstart.multi_fidelity(iterations=EX_MF, **f32),
        mf_expected_counts(built=1, losses=a + b + 2 * c, requests=1), totals)
    check_losses("examples", "quickstart MF-DGP", losses, a + b + c)
    with recorded_so_bo() as rec:
        bo, secs["quickstart SO_BO"] = ex_step(
            "quickstart SO_BO", lambda: quickstart.bayesian_optimization(
                infills=2, train_iterations=EX_TRAIN, **EX_DE, **f32),
            lambda _: launch_vector(c7=rec["c7"]), totals)
    check_loop_trace("quickstart SO_BO", bo.Ymin, 0.0625)
    with restart_candidates() as seen:
        (mo, losses, ehvi), secs["quickstart MO-DGP"] = ex_step(
            "quickstart MO-DGP and EHVI",
            lambda: quickstart.multi_objective(iterations=EX_MO, **f32),
            lambda _: mo_expected_counts(built=1, losses=len(seen) * EX_MO,
                                         scores=len(seen), requests=1),
            totals)
    check_losses("examples", "quickstart MO-DGP", losses, EX_MO)
    if not (ehvi.shape == (2,) and np.all(np.isfinite(ehvi))
            and np.all(ehvi >= 0)):
        raise AssertionError(f"[examples] quickstart EHVI {ehvi}")
    log(f"[examples] quickstart (float32): DGP {EX_DGP} steps "
        f"{secs['quickstart DGP']:.2f} s, train RMSE {rmse:.4f}; MF-DGP "
        f"{EX_MF} {secs['quickstart MF-DGP']:.2f} s, r2 {metrics['r2']:.4f}; "
        f"SO_BO 2 infills {secs['quickstart SO_BO']:.2f} s, Ymin "
        f"{float(bo.Ymin[-1]):.5f}; MO-DGP {EX_MO} steps, {len(seen)} "
        f"schedules, {secs['quickstart MO-DGP']:.2f} s, EHVI "
        f"{np.round(ehvi, 4)}; launches {COUNTED} {counts()} ({gpu})")

    # serving ----------------------------------------------------------------
    (trained, served), secs["serving"] = ex_step(
        "serving: train and reload",
        lambda: serving.train_and_reload(iterations=EX_SERVE, **f32),
        add_counts(launch_vector(c7=4), nonwhite(EX_SERVE, 2)), totals)
    if not all(torch.equal(p, q) for p, q in zip(
            trained.params.parameters(), served.params.parameters())):
        raise AssertionError("[examples] serving: the reloaded parameters "
                             "differ from the trained ones")
    chunks = -(-1003 // 256)
    with serving.process_group(DEVICE) as mesh:
        (whole, chunked), dt_req = ex_step(
            "serving: requests", lambda: serving.requests(served, mesh),
            expected_counts("nonwhite", 1 + chunks, 2), totals)
        with zero_normals():
            (w0, c0), _ = ex_step(
                "serving: requests on zero normals",
                lambda: serving.requests(served, mesh),
                expected_counts("nonwhite", 1 + chunks, 2), totals)
    err = 0.0
    for a_, b_ in zip(w0, c0):
        err = max(err, float((a_ - b_).abs().max() / a_.abs().max()))
    if not (whole[0].shape == chunked[0].shape == (50, 1003, 1)
            and all(bool(torch.isfinite(t).all()) for t in (*whole, *chunked))
            and err <= 1e-6):
        raise AssertionError(f"[examples] serving: whole and chunked "
                             f"requests differ by {err:.3g} of scale")
    log(f"[examples] serving: {EX_SERVE} Adam steps and the reload "
        f"{secs['serving']:.2f} s; the 1,003-row sharded request whole and in "
        f"{chunks} chunks of 256 {1e3 * dt_req:.1f} ms; on zero normals the "
        f"two within {err:.3g} of scale ({gpu})")

    # ask/tell ---------------------------------------------------------------
    with recorded_so_bo() as rec:
        (bo, seen), secs["ask_tell"] = ex_step(
            "ask/tell", lambda: (lambda b: (b, ask_tell.asynchronous(
                b, train_iterations=EX_TRAIN, **EX_DE)))(ask_tell.batches(
                    rounds=2, batch_size=3, train_iterations=EX_TRAIN,
                    **EX_DE, **f32)),
            lambda _: launch_vector(c7=rec["c7"]), totals)
    check_loop_trace("ask/tell", bo.Ymin, 0.397887)
    if seen != [2, 1, 0] or bo.X.shape != (8 + 6 + 2, 2):
        raise AssertionError(f"[examples] ask/tell: pending {seen}, "
                             f"archive {bo.X.shape}")
    log(f"[examples] ask/tell: 2 rounds of 3 and the asynchronous pair "
        f"{secs['ask_tell']:.2f} s, best {float(bo.Ymin[-1]):.5f}, pending "
        f"{seen}; #7 {rec['c7']} ({gpu})")

    # classification ---------------------------------------------------------
    (acc, logd, losses), secs["classification"] = ex_step(
        "classification",
        lambda: classification.main(iterations=EX_CLS, **f32),
        cls_expected_counts(built=1, losses=EX_CLS, requests=2), totals)
    check_losses("examples", "classification", losses, EX_CLS)
    log(f"[examples] classification: {EX_CLS} Adam steps "
        f"{secs['classification']:.2f} s, accuracy {acc:.3f}, mean "
        f"log-density {logd:.3f} ({gpu})")

    # mf_bo ------------------------------------------------------------------
    de = EX_DE["iterations_DE"]
    for name, run in (
            ("main", lambda: mf_bo.main(infills=2, model_dic=EX_AR1, **EX_DE,
                                        **f32)),
            ("constrained", lambda: mf_bo.constrained_demo(
                infills=1, model_dic=EX_AR1,
                model_C_dic={"kernels": "rbf", "iterations": EX_TRAIN},
                **EX_DE, **f32)),
            ("variant dims", lambda: mf_bo.variant_dims_demo(
                infills=1, schedule=(10, 5, 5), **EX_DE, **f32))):
        with recorded_loops(mf_bo.MF_BO, recorded_loop) as loops:
            bo, secs[f"mf_bo {name}"] = ex_step(
                f"mf_bo {name}", run, lambda _: reckon_loop(
                    loops[0][0], loops[0][1]["ops"], de), totals)
        check_loop_trace(f"mf_bo {name}", bo.best_trace,
                         FORRESTER_FLOOR if name != "variant dims"
                         else -math.inf)
        log(f"[examples] mf_bo {name}: {len(bo.fidelity_choices)} infills "
            f"{secs[f'mf_bo {name}']:.2f} s, best {bo.best_trace[-1]:.4f}, "
            f"fidelities {bo.fidelity_choices} ({gpu})")

    # mo_bo ------------------------------------------------------------------
    for name, run in (
            ("GPR pair", lambda: mo_bo.main(infills=1, S=200,
                                            model_dic=EX_GPR_PAIR, **EX_DE,
                                            **f32)),
            ("coupled", lambda: mo_bo.coupled(schedule=(10, 0, 0),
                                              restarts=1, **EX_DE, **f32))):
        with recorded_loops(mo_bo.MO_BO, recorded_mo_loop) as loops:
            bo, secs[f"mo_bo {name}"] = ex_step(
                f"mo_bo {name}", run, lambda _: reckon_mo_loop(
                    loops[0][1]["ops"], loops[0][1]["guards"][0]), totals)
        trace = np.asarray(bo.hv_trace)
        if not (np.all(np.isfinite(trace)) and np.all(np.diff(trace) >= 0)):
            raise AssertionError(f"[examples] mo_bo {name}: hypervolume "
                                 f"{trace}")
        log(f"[examples] mo_bo {name}: 1 infill {secs[f'mo_bo {name}']:.2f} "
            f"s, hypervolume {trace[0]:.5f} -> {trace[-1]:.5f} ({gpu})")

    # recipes ----------------------------------------------------------------
    n1, n2 = EX_LARGE_ITERS
    stationary = lambda n: expected_counts("stationary", n, 2, loss=True)  # noqa: E731
    large = {}
    with serving.process_group(DEVICE) as mesh:
        for M in (128, 256):
            kernels = M == 128
            (model, losses, _), dt = ex_step(
                f"recipe (a) M = {M}", lambda: recipes.minibatched_training(
                    mesh, N=EX_N, M=M, B=EX_B, iterations=EX_LARGE_ITERS,
                    **f32),
                stationary(n1 + 2 * n2) if kernels else launch_vector(),
                totals)
            check_losses("examples", f"recipe (a) M = {M}", losses, n1 + n2)
            run = lambda: model.optimize_adam(iterations=EX_TIMED,  # noqa: E731
                                              messages=0, shrink_inner=False)
            ms = [t / EX_TIMED for t in timed_rounds({M: run}, 3)[M]]
            idle_share(f"recipe (a) M = {M}, {EX_TIMED} Adam steps", run, gpu,
                       tag="examples")
            # the warm-up call, 3 rounds and the profiled run
            totals[0] = add_counts(totals[0], stationary(5 * EX_TIMED)
                                   if kernels else launch_vector())
            check_launches("examples", f"recipe (a) M = {M} timed",
                           totals[0])
            large[M] = model
            log(f"[examples] recipe (a) N {EX_N:,}, B {EX_B:,}, S 10, M {M} "
                f"({'#1/#2' if kernels else 'eager: no kernel launched'}): "
                f"optimize_nat_adam {EX_LARGE_ITERS} {dt:.2f} s, loss "
                f"{losses[0]:.1f} -> {losses[-1]:.1f}; Adam step ms "
                f"{', '.join(f'{t:.3f}' for t in ms)} over {EX_TIMED} steps, "
                f"3 rounds ({gpu})")
        fresh = recipes.large_model(EX_N, 128, EX_B, mesh, **f32)
        with checkpoint_snapshots() as snapshots:
            (path, losses), dt = ex_step(
                "recipe (b)", lambda: recipes.checkpointed_training(
                    large[128], fresh, iterations=4, every=2, more=2),
                stationary(2 * 4 + 2 * 2), totals)
        reloaded = recipes.large_model(EX_N, 128, EX_B, mesh, **f32)
        recipes.checkpoint.load(path, reloaded.params)
        state = reloaded.params.state_dict()
        if [done for done, _ in snapshots] != [2] or not all(
                torch.equal(state[k], v) for k, v in snapshots[0][1].items()):
            raise AssertionError("[examples] recipe (b): the checkpoint does "
                                 "not reload bit for bit")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"[examples] recipe (b): losses {losses}")
    with recorded_so_bo() as rec:
        (resumed, whole), dt_c = ex_step(
            "recipe (c)", lambda: recipes.bo_resume(
                train_iterations=EX_TRAIN, **EX_DE, **f32),
            lambda _: launch_vector(c7=rec["c7"]), totals)
    log(f"[examples] recipe (b): a checkpoint after 2 of 4 natural-gradient "
        f"steps reloaded bit for bit, 2 more steps {dt:.2f} s; recipe (c): "
        f"SO_BO resumed after 2 infills equals the uninterrupted 3 bit for "
        f"bit (Ymin {float(resumed.Ymin[-1]):.5f}) {dt_c:.2f} s ({gpu})")
    log(f"[examples] phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{COUNTED} {counts()}, reckoned {totals[0]} ({gpu})")
    return counts()


# -- phase 15 -------------------------------------------------------------------


def event_ms(fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ops_ms(flops, b_flops, tensor_cores):
    """Least ms for ``flops`` operations, ``b_flops`` of them the products
    b_d = Sq[d] A: all at the fp32 peak, or with ``tensor_cores`` those
    products in 3xTF32 (three TF32 products each) at the dense TF32 peak."""
    if not tensor_cores:
        return 1e3 * flops / PEAK_FP32_FLOPS
    return 1e3 * ((flops - b_flops) / PEAK_FP32_FLOPS
                  + 3 * b_flops / PEAK_TF32_FLOPS)


def fused_bound_ms(Pinv, Xs, q_mu, Sq, tensor_cores=False):
    """Least time for the fused conditional on these inputs: its FLOP over
    the peak rate or its bytes (each input read once, each output written
    once) over the memory rate, whichever is larger. The two M x M products
    count only the nonzeros of Pinv and Sq: on the whitened path these are
    triangular, so the function needs M(M+1) FLOP per point for each. With
    ``tensor_cores`` the products b_d run at the rate of the kernel's route
    (:func:`ops_ms`); else every operation at the fp32 peak."""
    n, Din = Xs.shape
    Mi, D = q_mu.shape
    nnz_s = int(torch.count_nonzero(Sq))
    nnz = int(torch.count_nonzero(Pinv)) + nnz_s
    # cross term z.x, the Pinv and Sq products, mean, t1 = ||A||^2, t2
    per_point = 2 * Mi * Din + 2 * nnz + 2 * Mi * D + 2 * Mi + 2 * Mi * D
    t_ops = ops_ms(float(n) * per_point, float(n) * 2 * nnz_s, tensor_cores)
    nbytes = 4.0 * (n * Din + Mi * Mi + Mi * Din + 1 + Mi * D + D * Mi * Mi
                    + 2 * n * D)
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_kernel(kind, D, Din, n, gpu):
    """Kernel #1 through its wrapper (CUDA events) and on the device alone
    (torch.profiler) beside its plain version and its bound: the route's
    (b_d on the tensor cores), and the fp32 bound (every operation at the
    fp32 peak) beside it."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, M, Din, n, 11, "cuda")
    run = lambda: cfr._launch(kind, *args)
    with torch.no_grad():
        ms = event_ms(run, 10)
        plain_ms = event_ms(lambda: cfr.fused_conditional_plain(kind, *args), 5)
        dev_us, seen = device_us(run, 5, "fused_fwd")
    Pinv, Xs, _, _, q_mu, Sq = args
    bound, by = fused_bound_ms(Pinv, Xs, q_mu, Sq, tensor_cores=True)
    fp32_bound, _ = fused_bound_ms(Pinv, Xs, q_mu, Sq)
    log(f"[timing] fused conditional (#1) {KINDS[kind]} D={D} M={M} Din={Din} "
        f"n={n}: kernel {ms:.3f} ms (device {fmt_us(dev_us)} over "
        f"{round(5 * seen)} of 5 launches), plain "
        f"{plain_ms:.3f} ms, bound {bound:.3f} ms ({by}; b_d in 3xTF32 on "
        f"the tensor cores), {bound / ms:.1%} of the bound; fp32 bound "
        f"{fp32_bound:.3f} ms, {fp32_bound / ms:.1%} ({gpu})")
    return ms, plain_ms, bound, by, fp32_bound


def backward_bound_ms(Pinv, Xs, q_mu, Sq):
    """Least time for the fused conditional's backward on these inputs, as
    :func:`fused_bound_ms` reckons it. Six M x M products per output count
    the nonzeros of Pinv and Sq (triangular on the whitened path): a, dkuf
    and dPinv on Pinv's pattern, b_d, Sq[d]^T gb_d and dSq[d] on Sq's (only
    those entries of dPinv and dSq reach a parameter), where the kernel
    spends 2M^2 on each full square."""
    n, Din = Xs.shape
    Mi, D = q_mu.shape
    nnz = int(torch.count_nonzero(Pinv)) + int(torch.count_nonzero(Sq))
    per_point = (2 * Mi * Din            # cross term z.x
                 + 3 * 2 * nnz           # the six triangular products
                 + 2 * Mi + 2 * Mi * D   # t1, t2
                 + 4 * Mi * D            # q_mu g_mean^T, dq_mu
                 + 2 * Mi                # sum(dkuf kuf)
                 + 4 * Mi * Din)         # dsq^T zs, dsq xs
    flops = float(n) * per_point
    small = Mi * Mi + Mi * Din + 1 + Mi * D + D * Mi * Mi
    nbytes = 4.0 * (n * Din + small + 2 * n * D      # inputs, g_mean, g_var
                    + n * Din + small)               # dXs and the summed outputs
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def whitened_traffic_gb(module, Mi, D, n, with_kuf):
    """GB a whitened backward (#2, #4: ``module``) moves through its
    scratch, reckoned from the shapes (not measured): phase A writes A, dA
    (and Kuf with ``with_kuf``) [M, n] and gv [D, n]; phase B reads both
    operands of each of its D + 1 Grams and gv; the slices' partial sums
    (one per slice of the library's size) are written once and read once by
    the reduction."""
    from dgp_tpu_torch.ops import _launch

    slices = -(-n // _launch.plan_size(module._library(), module._PREFIX, "slice"))
    writes = n * ((3 if with_kuf else 2) * Mi + D)
    reads = n * (2 * Mi * (D + 1) + D)
    partials = 2 * slices * (D + 1) * Mi * Mi
    return 4e-9 * (writes + reads + partials)


def scratch_mb(module, n, Mi, D, small, with_kuf):
    """MB of a whitened backward's scratch for n points (its largest pass)."""
    from dgp_tpu_torch.ops import _launch

    sc = _launch.backward_scratch(module._library(), module._PREFIX, n, Mi, D,
                                  small, with_kuf, DEVICE)
    return 4e-6 * sum(t.numel() for t in vars(sc).values()
                      if isinstance(t, torch.Tensor))


def device_split(fn, reps, groups):
    """Device µs per call of ``fn`` by group of kernels, from one
    torch.profiler run over ``reps`` warm calls: ``groups`` maps a label to
    the name fragments of its kernels; None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    out = {}
    for label, fragments in groups.items():
        total = sum(e.self_device_time_total for e in events
                    if any(f in e.key for f in fragments))
        out[label] = total / reps if total > 0 else None
    return out


def phases_line(split):
    return ", ".join(f"{k} {fmt_us(v)}" for k, v in split.items())


def time_backward(kind, D, Din, n, gpu):
    """Kernel #2 through the wrapper's launch (both phases, scratch
    allocation included) beside its plain version and the unchanged bound,
    and the device time of phase A, phase B and the reductions apart."""
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    args = fused_inputs(kind, D, M, Din, n, 12, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = [torch.randn((n, D), generator=gen, device="cuda") for _ in range(2)]
    run = lambda: cfr._launch_backward(kind, *args, *g)
    with torch.no_grad():
        ms = event_ms(run, 10)
        plain_ms = event_ms(
            lambda: cfr.fused_conditional_backward_plain(kind, *args, *g), 5)
        split = device_split(run, 5, {
            "phase A": ("fused_bwd_a",), "phase B": ("gram_bwd", "gram_finish"),
            "reductions": ("reduce_parts",)})
    Pinv, Xs, _, _, q_mu, Sq = args
    bound, by = backward_bound_ms(Pinv, Xs, q_mu, Sq)
    mb = scratch_mb(cfr, n, M, D, M * Din + M * D + 1, True)
    log(f"[timing] fused conditional backward {KINDS[kind]} D={D} M={M} "
        f"Din={Din} n={n}: both phases {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound:.3f} ms ({by}), {bound / ms:.1%} of the bound; device "
        f"{phases_line(split)}; scratch {mb:.1f} MB, scratch traffic "
        f"{whitened_traffic_gb(cfr, M, D, n, True):.2f} GB per call (reckoned) ({gpu})")
    return ms, plain_ms, bound, by


def gram_bound_ms(Mi, D, n):
    """Least time for phase B of a whitened backward on these shapes: the
    lower triangles of the D weighted Grams (with gv's weighting) and of
    dA Kuf^T, and dSq = triu(2 Sq C) over Sq's nonzeros, over the fp32
    peak; or A, dA, Kuf and gv read and dPinv and dSq written once over the
    memory rate, whichever is larger."""
    tri = Mi * (Mi + 1)
    flops = float(n) * ((D + 1) * tri + D * Mi) + 2 * D * tri * (2 * Mi + 1) / 6
    nbytes = 4.0 * (3 * Mi * n + D * n + D * Mi * Mi + (1 + D) * Mi * Mi)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_gram(module, D, n, gpu):
    """Phase B of a whitened backward alone (``module``'s gram_backward)
    beside its plain version and its bound."""
    args = gram_inputs(D, M, n, 15)
    with torch.no_grad():
        ms = event_ms(lambda: module.gram_backward(*args), 10)
        plain_ms = event_ms(lambda: module.gram_backward_plain(*args), 5)
    bound, by = gram_bound_ms(M, D, n)
    log(f"[timing] phase B of {module.__name__.split('.')[-1]} D={D} M={M} "
        f"n={n}: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({by}), {bound / ms:.1%} of the bound ({gpu})")
    return ms, plain_ms, bound, by


def quadform_bound_ms(Sq, n, backward=False, tensor_cores=False):
    """Least time for the quadform (t2 without t1) or its backward on these
    inputs, as :func:`fused_bound_ms` reckons it: each M x M product counts
    the nonzeros of Sq (upper-triangular on the conditional's path, M(M+1)/2
    per output). Forward: b_d = Sq[d] a (with ``tensor_cores``, at the rate
    of #5's route, :func:`ops_ms`) and ||b_d||^2; backward (all fp32):
    b_d, gb_d = 2 b_d g_d, Sq[d]^T gb_d and gb_d a^T (only Sq's pattern of
    dSq reaches q_sqrt)."""
    D, Mi = Sq.shape[0], Sq.shape[1]
    nnz = int(torch.count_nonzero(Sq))
    if backward:
        per_point = 3 * 2 * nnz + 2 * D * Mi
        # A, g2 and Sq read; dA and dSq written
        nbytes = 4.0 * (2 * Mi * n + D * n + 2 * D * Mi * Mi)
    else:
        per_point = 2 * nnz + 2 * D * Mi
        nbytes = 4.0 * (Mi * n + D * n + D * Mi * Mi)  # A, Sq read; t2 written
    t_ops = ops_ms(float(n) * per_point, float(n) * 2 * nnz,
                   tensor_cores and not backward)
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_quadform(D, n, gpu, backward=False):
    """Kernel #5, or #6 (both phases through the wrapper's launch, phase
    B's buffers included, with the device time of each phase apart), beside
    its plain version and its bound: #5's route's (b_d on the tensor cores)
    with the fp32 bound beside it; #6's all fp32."""
    from dgp_tpu_torch.ops import quadform as qf

    Sq, A, g2, _ = quadform_inputs(D, M, n, 13, "cuda")
    with torch.no_grad():
        if backward:
            run = lambda: qf._launch_backward(Sq, A, g2, None)
            ms = event_ms(run, 10)
            plain_ms = event_ms(lambda: qf.quadform_backward_plain(Sq, A, g2), 5)
            split = device_split(run, 5, {
                "phase A": ("quadform_bwd_a",),
                "phase B": ("gram_bwd", "gram_finish"),
                "reductions": ("reduce_parts",)})
        else:
            run = lambda: qf._launch(Sq, A, False)
            ms = event_ms(run, 10)
            plain_ms = event_ms(lambda: qf.quadform_t2_reference(Sq, A), 5)
            dev_us, seen = device_us(run, 5, "quadform_fwd")
    bound, by = quadform_bound_ms(Sq, n, backward, tensor_cores=True)
    fp32_bound, _ = quadform_bound_ms(Sq, n, backward)
    if backward:
        extra = f"; device {phases_line(split)}"
    else:
        extra = (f" (b_d in 3xTF32 on the tensor cores); device "
                 f"{fmt_us(dev_us)} over {round(5 * seen)} of 5 launches; fp32 "
                 f"bound {fp32_bound:.3f} ms, {fp32_bound / ms:.1%}")
    log(f"[timing] quadform{' backward (#6)' if backward else ' (#5)'} D={D} "
        f"M={M} n={n}: {'both phases' if backward else 'kernel'} {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}), "
        f"{bound / ms:.1%} of the bound{extra} ({gpu})")
    return ms, plain_ms, bound, by, fp32_bound


def fused_white_bound_ms(Pinv, Kuf, q_mu, Sq, backward=False, tensor_cores=False):
    """Least time for kernel #3 (or #4) on these inputs, as
    :func:`fused_bound_ms` reckons it: each M x M product counts the nonzeros
    of Pinv and Sq (triangular on the whitened path). Forward: a = Pinv kuf
    and the D products b_d = Sq[d] a, the mean, t1 and t2 (with
    ``tensor_cores``, b_d at the rate of the kernel's route). Backward: a,
    dKuf = Pinv^T da and dPinv on Pinv's pattern, b_d, Sq[d]^T gb_d and dSq[d]
    on Sq's (only those entries reach a parameter), t1, t2, q_mu g_mean^T and
    dq_mu. Bytes: Kuf and Kff read and mean and var written (forward); Kuf,
    Kff, g_mean and g_var read and dKuf, dKff written (backward); plus the
    small operands and sums once."""
    Mi, n = Kuf.shape
    D = q_mu.shape[1]
    nnz_p, nnz_s = int(torch.count_nonzero(Pinv)), int(torch.count_nonzero(Sq))
    small = Mi * Mi + Mi * D + D * Mi * Mi
    if backward:
        per_point = 3 * 2 * (nnz_p + nnz_s) + 2 * Mi + 2 * Mi * D + 4 * Mi * D
        nbytes = 4.0 * (2 * (Mi * n + n) + 2 * n * D + 2 * small)
    else:
        per_point = 2 * (nnz_p + nnz_s) + 2 * Mi * D + 2 * Mi + 2 * Mi * D
        nbytes = 4.0 * (Mi * n + n + 2 * n * D + small)
    t_ops = ops_ms(float(n) * per_point, float(n) * 2 * nnz_s,
                   tensor_cores and not backward)
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_fused_white(D, n, gpu, backward=False):
    """Kernel #3 (or #4, both phases through the wrapper's launch, scratch
    allocation included, with the device time of each phase apart) beside
    its plain version, on the operands of an RBF + Linear layer
    (Din = 8)."""
    from dgp_tpu_torch.ops import conditional_fused as cf

    args = composite_inputs(D, M, DIN, n, 14)
    split = {}
    with torch.no_grad():
        if backward:
            gen = torch.Generator(device=DEVICE).manual_seed(14)
            g = [torch.randn((n, D), generator=gen, device=DEVICE) for _ in range(2)]
            run = lambda: cf._launch_backward(*args, *g)
            ms = event_ms(run, 10)
            plain_ms = event_ms(
                lambda: cf.fused_conditional_white_backward_plain(*args, *g), 5)
            split = device_split(run, 5, {
                "phase A": ("conditional_fused_bwd_a",),
                "phase B": ("gram_bwd", "gram_finish"),
                "reductions": ("reduce_parts",)})
        else:
            run = lambda: cf._launch(*args)
            ms = event_ms(run, 10)
            plain_ms = event_ms(lambda: cf.fused_conditional_white_plain(*args), 5)
            dev_us, seen = device_us(run, 5, "conditional_fused_fwd")
    Pinv, Kuf, q_mu, Sq, _ = args
    bound, by = fused_white_bound_ms(Pinv, Kuf, q_mu, Sq, backward,
                                     tensor_cores=True)
    fp32_bound, _ = fused_white_bound_ms(Pinv, Kuf, q_mu, Sq, backward)
    if backward:
        extra = (f"; device {phases_line(split)}; scratch "
                 f"{scratch_mb(cf, n, M, D, M * D, False):.1f} MB, scratch "
                 f"traffic {whitened_traffic_gb(cf, M, D, n, False):.2f} GB per "
                 f"call (reckoned)")
    else:
        extra = (f" (b_d in 3xTF32 on the tensor cores); device "
                 f"{fmt_us(dev_us)} over {round(5 * seen)} of 5 launches; "
                 f"fp32 bound {fp32_bound:.3f} ms, "
                 f"{fp32_bound / ms:.1%}")
    log(f"[timing] fused whitened{' backward (#4)' if backward else ' (#3)'} "
        f"D={D} M={M} n={n}: {'both phases' if backward else 'kernel'} "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}), "
        f"{bound / ms:.1%} of the bound{extra} ({gpu})")
    return ms, plain_ms, bound, by, fp32_bound


def cholesky_bound_ms(G, Mi, inverse):
    """Least time for kernel #7 (#8) on a [G, Mi, Mi] stack: the M^3/3 FLOP
    of the factorization (and as many again for the inverse) per matrix over
    the fp32 peak, or the lower triangle of the stack (all the function
    reads) read once and L (and W) written once over the memory rate,
    whichever is larger."""
    flops = G * (2 if inverse else 1) * Mi ** 3 / 3
    nbytes = 4.0 * G * (Mi * (Mi + 1) / 2 + Mi * Mi * (2 if inverse else 1))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def device_us(fn, reps, name=None):
    """(device µs per call, kernels per call) of ``fn`` over ``reps`` warm
    calls, from torch.profiler: the kernels whose name holds ``name``, or
    all of them. (None, 0) where the profiler saw no device time. A named
    kernel launches once per call; its time is the mean over the launches
    the profiler kept, which can be fewer than ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0
               and (name is None or name in e.key)]
    total = sum(e.self_device_time_total for e in kernels)
    count = sum(e.count for e in kernels)
    if total <= 0:
        return None, 0
    return (total / count if name else total / reps), count / reps


def fmt_us(us):
    return "not measured" if us is None else f"{us:.1f} us"


def time_cholesky(G, Mi, inverse, gpu, kuu="model", stack=None):
    """Kernel #7 (#8) through its wrapper's launch beside its plain version
    and the library calls that compute the same function:
    torch.linalg.cholesky_ex (with solve_triangular against the identity
    for #8), timed here and used nowhere in the port. CUDA events over
    back-to-back calls give the time a caller sees (the larger of host and
    device time per call); torch.profiler over the same calls gives the
    device time of the kernel alone and of the library's kernels. With
    ``stack``, on that float32 stack (named ``kuu``)."""
    from dgp_tpu_torch.ops import cholesky as tch

    A = spd_stack(G, Mi, 15, kuu) if stack is None else stack
    eye = torch.eye(Mi, device=DEVICE).expand(A.shape)

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.linalg.solve_triangular(L, eye, upper=False) if inverse else L

    kernel = lambda: tch._launch(A, inverse)
    with torch.no_grad():
        ms = event_ms(kernel, 200)
        plain = tch.cholesky_inverse_plain if inverse else tch.cholesky_plain
        plain_ms = event_ms(lambda: plain(A), 200)
        library_ms = event_ms(library, 200)
        dev_us, _ = device_us(kernel, 100, "cholesky_kernel")
        lib_us, lib_kernels = device_us(library, 100)
    bound, by = cholesky_bound_ms(G, Mi, inverse)
    what = "#8 chol+inverse" if inverse else "#7 chol"
    what += "" if stack is None else f" ({kuu})"
    log(f"[timing] {what} G={G} M={Mi}: events: kernel {1e3 * ms:.1f} us, plain "
        f"{1e3 * plain_ms:.1f} us, library {1e3 * library_ms:.1f} us; device "
        f"(profiler): kernel {fmt_us(dev_us)}, library {fmt_us(lib_us)} in "
        f"{lib_kernels:g} kernels per call; bound {1e3 * bound:.3f} us ({by}), "
        f"{bound / ms:.2%} of the bound ({gpu})")
    return ms, plain_ms, bound, by, library_ms, dev_us, lib_us


@contextlib.contextmanager
def cholesky_route(route):
    """The port's Kuu and Gram factorizations through "kernels" (#7, #8,
    even inside kernels_scope(False)), "plain" (their plain versions:
    cholesky_ex with the NaN fill, no host read) or "checked"
    (torch.linalg.cholesky, which reads the
    factorization's status back to the host, and solve_triangular: the
    calls the port made before #7 and #8)."""
    from dgp_tpu_torch.ops import cholesky as tch

    def checked(A):
        return torch.linalg.cholesky(A)

    def checked_inverse(A):
        L = torch.linalg.cholesky(A)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        return L, torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                                upper=False)

    saved = (tch.use_kernels, tch.applicable, tch.cholesky_plain,
             tch.cholesky_inverse_plain)
    if route == "kernels":
        # whatever kernels_scope says for the other kernels
        tch.use_kernels = lambda: True
    else:
        tch.applicable = lambda *args, **kwargs: False
    if route == "checked":
        tch.cholesky_plain, tch.cholesky_inverse_plain = checked, checked_inverse
    try:
        yield
    finally:
        (tch.use_kernels, tch.applicable, tch.cholesky_plain,
         tch.cholesky_inverse_plain) = saved


def time_cholesky_variants(model, gpu, steps=10, rounds=3):
    """One precompute_projections of bench.py's whitened model (its
    [2, 128, 128] Kuu stack and Pinv; CUDA events over 50 calls) and its
    Adam step (host clock around 10 steps), with the factorizations through
    each cholesky_route, the routes taken in turns."""
    from dgp_tpu_torch.layers.svgp import stack_projections

    layers = model.params.layers
    routes = ("kernels", "plain", "checked")
    pre, step = {r: [] for r in routes}, {r: [] for r in routes}
    for _ in range(rounds):
        for route in routes:
            with cholesky_route(route), torch.no_grad():
                pre[route].append(1e3 * event_ms(
                    lambda: stack_projections(layers, [l.z for l in layers]), 50))
            with cholesky_route(route):
                run = lambda: model.optimize_adam(iterations=steps, messages=0,
                                                  shrink_inner=False)
                run()
                step[route].append(1e3 * timed(run)[1] / steps)
    for route in routes:
        log(f"[timing] bench.py whitened model, factorizations via {route}: "
            f"precompute_projections {', '.join(f'{t:.1f}' for t in pre[route])} "
            f"us; Adam step {', '.join(f'{t:.2f}' for t in step[route])} ms "
            f"({gpu})")


def time_steps(model, gpu, steps=10, rounds=3, nat=True):
    """Wall time per training step, synchronised around a run of steps.
    Host-clock times spread with the load on the machine's CPU cores, so
    each is taken ``rounds`` times and all are shown."""
    phases = {
        "Adam step": lambda: model.optimize_adam(
            iterations=steps, messages=0, shrink_inner=False),
    }
    if nat:
        phases["Adam + natural-gradient step"] = lambda: model.optimize_nat_adam(
            iterations1=0, iterations2=steps, messages=0, shrink_inner=False)
    what = WHAT[path_of(model)]
    for step, run in phases.items():
        run()
        ms = sorted(1e3 * timed(run)[1] / steps for _ in range(rounds))
        log(f"[timing] {what} {step} (N={N_TRAIN}, S={S}, 2 layers), ms per "
            f"step over {steps} steps, {rounds} rounds: "
            f"{', '.join(f'{t:.2f}' for t in ms)}; best {1e3 / ms[0]:.1f} "
            f"steps/s ({gpu})")


def profile_run(what, fn, gpu):
    """Device time by kernel over one warm run of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    timed(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] {what}: the profiler saw no device time: not measured")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {what} under the profiler: wall {1e3 * wall:.2f} ms, "
        f"device busy {busy:.2f} ms ({busy / (1e3 * wall):.1%}), idle "
        f"{1 - busy / (1e3 * wall):.1%} ({gpu})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<3d} "
            f"{e.key[:100]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    log(f"[profile] host, self time: " + "; ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.2f} ms x{e.count}"
        for e in host[:6]))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from dgp_tpu_torch.ops import conditional_fused as cf
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    gpu = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(gpu)
    build()
    log(f"[kernels] widest D of the whitened plans at M = {M}: {plan_widths()}")

    err = err_bwd = 0.0
    for kind in KINDS:
        for seed, (D, Mi, Din, n) in enumerate([
                (HIDDEN, M, DIN, 262_144 + 37),   # layer 1 of the model
                (1, M, HIDDEN, 262_144 + 37),     # layer 2
                (3, 64, 5, 10_007),               # small odd shape
                # either side of a tile's edge and of the padded M, and more
                # tiles than resident blocks, at the layers' input width
                *[(3, m, DIN, t) for m in EDGE_M for t in FORWARD_EDGE_N]]):
            err = max(err, check_kernel(kind, D, Mi, Din, n, 10 * kind + seed))
        # Din = 5 at M = 100 and 128: Kuu ill-conditioned, the witness rule
        for seed, (Mi, n) in enumerate(
                [(m, t) for m in WITNESS_M for t in FORWARD_EDGE_N]):
            err = max(err, check_kernel(kind, 3, Mi, 5, n, 50 + 100 * kind + seed,
                                        witness=True))
    # an RBF draw at M = 128, n = 1,025 where plain fp32 is itself beyond
    # TOL of scale (1.06e-4 on the CPU): the witness rule
    err = max(err, check_kernel(0, 3, M, 5, 1_025, 5, witness=True))
    for kind in KINDS:
        for seed, (D, Mi, Din, n) in enumerate([
                (HIDDEN, M, DIN, S * N_TRAIN + 37),   # layer 1, training
                (1, M, HIDDEN, S * N_TRAIN + 37),     # layer 2
                (3, 64, 5, 10_007),
                # either side of a tile's edge and of the padded M, at the
                # layers' input width
                *[(3, m, DIN, t) for m in EDGE_M for t in BACKWARD_EDGE_N]]):
            err_bwd = max(err_bwd, check_backward(kind, D, Mi, Din, n,
                                                  100 + 100 * kind + seed))
        for seed, (D, Mi, Din, n) in enumerate([
                (HIDDEN, M, DIN, S * N_TRAIN + 37), (2, 100, DIN, 1_037)]):
            err_bwd = max(err_bwd, check_backward(kind, D, Mi, Din, n,
                                                  150 + 100 * kind + seed,
                                                  clamp=True))
    # one point past the first pass of points: two passes, their sums added
    err_bwd = max(err_bwd, check_backward(0, HIDDEN, M, DIN, pass_edge(), 199))
    # Din = 5 at M = 100 and 128, and one more RBF draw at M = 128, n = 63:
    # Kuu ill-conditioned, held by the witness rule
    for kind in KINDS:
        for seed, (Mi, n) in enumerate(
                [(m, t) for m in WITNESS_M for t in BACKWARD_EDGE_N]):
            err_bwd = max(err_bwd, check_backward(
                kind, 3, Mi, 5, n, 170 + 100 * kind + seed, witness=True))
    err_bwd = max(err_bwd, check_backward(0, 3, M, 5, 63, 114, witness=True))
    err_gram = {"rbf": 0.0, "white": 0.0}
    for seed, D in enumerate((HIDDEN, 1)):   # the layers' phase-B shapes
        err_gram["rbf"] = max(err_gram["rbf"], check_gram(
            cfr, D, M, S * N_TRAIN, 700 + seed))
        err_gram["white"] = max(err_gram["white"], check_gram(
            cf, D, M, S * N_TRAIN, 710 + seed))

    err_qf = err_qf_bwd = 0.0
    # either side of a tile's edge and of the padded M, and one pass of
    # phase B and 37 points more
    quadform_edges = [(3, m, t) for m in EDGE_M for t in QUADFORM_EDGE_N]
    for seed, (D, Mi, n) in enumerate([
            (HIDDEN, M, 262_144 + 37),    # layer 1 of the model
            (1, M, 262_144 + 37),         # layer 2
            (3, 64, 10_007),              # small odd shapes; M = 100 is
            (2, 100, 1_037),              # padded to 128 in the kernels
            *BO_QUADFORM, *quadform_edges]):
        for with_t1 in (False, True):
            err_qf = max(err_qf, check_quadform(D, Mi, n, with_t1, 200 + seed))
    for seed, (D, Mi, n) in enumerate([
            (HIDDEN, M, S * N_TRAIN + 37),    # layer 1, training
            (1, M, S * N_TRAIN + 37),         # layer 2
            (3, 64, 10_007),
            (2, 100, 1_037),
            *BO_QUADFORM, *quadform_edges]):
        for with_t1 in (False, True):
            err_qf_bwd = max(err_qf_bwd, check_quadform_backward(
                D, Mi, n, with_t1, 300 + seed))
    # a non-whitened layer's own operands at the prior, where training starts
    for with_t1 in (False, True):
        err_qf = max(err_qf, check_quadform(2, 100, 1_037, with_t1, 290, prior=True))
        err_qf_bwd = max(err_qf_bwd, check_quadform_backward(
            2, 100, 1_037, with_t1, 390, prior=True))
    # the multi-fidelity model's shapes (D = 1, M = 30 and 5)
    for seed, (D, Mi, n) in enumerate(MF_QUADFORM):
        for with_t1 in (False, True):
            err_qf = max(err_qf, check_quadform(D, Mi, n, with_t1, 240 + seed))
            err_qf_bwd = max(err_qf_bwd, check_quadform_backward(
                D, Mi, n, with_t1, 340 + seed))
    # the Embedded Mapping model's shapes (D = 2 at M = 6, D = 1 at M = 30
    # and 6)
    for seed, (D, Mi, n) in enumerate(EM_QUADFORM):
        for with_t1 in (False, True):
            err_qf = max(err_qf, check_quadform(D, Mi, n, with_t1, 260 + seed))
            err_qf_bwd = max(err_qf_bwd, check_quadform_backward(
                D, Mi, n, with_t1, 360 + seed))

    err_fw = err_fw_bwd = 0.0
    for seed, (D, Mi, Din, n) in enumerate([
            (HIDDEN, M, DIN, 262_144 + 37),   # layer 1 of the model
            (1, M, HIDDEN, 262_144 + 37),     # layer 2
            (3, 64, 5, 10_007),               # small odd shapes; M = 100 is
            (2, 100, DIN, 1_037)]):           # padded to 128 in the kernels
        err_fw = max(err_fw, check_fused_white(D, Mi, Din, n, 400 + seed))
    # the edge shapes, at the layers' input width
    for seed, (Mi, n) in enumerate([(m, t) for m in EDGE_M for t in FORWARD_EDGE_N]):
        err_fw = max(err_fw, check_fused_white(3, Mi, DIN, n, 410 + seed))
    # M = 100 points in 3 dimensions: max|Pinv| ~ 93, fp32 itself off by
    # more than TOL of scale
    err_fw = max(err_fw, check_fused_white(2, 100, 3, 1_037, 403, witness=True))
    clamped = [(HIDDEN, M, DIN, S * N_TRAIN + 37), (2, 100, DIN, 1_037)]
    for seed, (D, Mi, Din, n) in enumerate(clamped):
        err_fw = max(err_fw, check_fused_white(D, Mi, Din, n, 450 + seed,
                                               clamp=True))
    for seed, (D, Mi, Din, n) in enumerate([
            (HIDDEN, M, DIN, S * N_TRAIN + 37),   # layer 1, training
            (1, M, HIDDEN, S * N_TRAIN + 37),     # layer 2
            (3, 64, 5, 10_007),
            (2, 100, DIN, 1_037)]):
        err_fw_bwd = max(err_fw_bwd, check_fused_white_backward(
            D, Mi, Din, n, 500 + seed))
    for seed, (D, Mi, Din, n) in enumerate(clamped):
        err_fw_bwd = max(err_fw_bwd, check_fused_white_backward(
            D, Mi, Din, n, 550 + seed, clamp=True))
    for seed, (D, Mi, Din, n) in enumerate([
            *[(3, m, DIN, t) for m in (*EDGE_M, 50) for t in BACKWARD_EDGE_N],
            (HIDDEN, M, DIN, pass_edge())]):
        err_fw_bwd = max(err_fw_bwd, check_fused_white_backward(
            D, Mi, Din, n, 560 + seed))

    # #7 and #8: the whitened models' [2, 128, 128] stack (the probe's
    # shape), a BO Gram-sized and two odd stacks, the models' own Kuu
    # conditioning at M = 128 and the BO surrogate's at M = 8
    err_chol = [0.0, 0.0]
    for seed, (G, Mi, kuu) in enumerate([
            (2, M, None), (3, 24, None), (1, 8, None), (1, 100, None),
            (2, M, "model"), (3, 8, "bo"),
            # either side of each panel edge, and a stack of G = 40 (the
            # full-covariance sampling's [S*D, N, N])
            *[(1, m, None) for m in CHOLESKY_EDGES], (40, 64, None)]):
        for inverse in (False, True):
            err_chol[inverse] = max(err_chol[inverse], check_cholesky(
                G, Mi, 600 + seed, inverse, kuu))
    for inverse in (False, True):  # the largest M of each plan
        err_chol[inverse] = max(err_chol[inverse], check_cholesky(
            1, largest_cholesky_m(inverse), 690 + inverse, inverse))
    # the Park and Park_VD models' own Kuu stacks, held to their float64
    # twins
    for name, stack in park_kuu() + em_kuu():
        for inverse in (False, True):
            err_chol[inverse] = max(err_chol[inverse], check_cholesky(
                stack[0].shape[0], stack[0].shape[-1], 0, inverse, kuu=name,
                stack=stack))
    # #7 on the Gram stacks the exact surrogates' engine factors, one launch
    # for all its starts, held to their float64 twins
    for name, stack, witness in exact_grams():
        err_chol[0] = max(err_chol[0], check_cholesky(
            stack[0].shape[0], stack[0].shape[-1], 0, False, kuu=name,
            stack=stack, witness=witness))

    # each main path's launch counts (zeroed just before it, read just
    # after); a kernel's launches in the kernels line are their sum
    paths = []
    model = serving_model()
    paths.append(serve(model, gpu))
    log(f"[serving] fused conditional launches on the serving path: "
        f"{paths[-1][0]}")
    compare_paths(model)
    compare_factorizations(model)
    model_nw = serving_model(white=False)
    paths.append(serve(model_nw, gpu))
    log(f"[serving] quadform launches on the non-whitened serving path: "
        f"{paths[-1][4]}")
    compare_paths(model_nw)
    compare_factorizations(model_nw)
    # bench.py's model with RBF + Linear layers, q moved off the prior (at
    # the prior t2 == t1, and Z's gradient is rounding)
    model_c = training_model(composite=True)
    perturb(model_c, np.random.default_rng(4))
    paths.append(serve(model_c, gpu))
    log(f"[serving] Kuf-consuming fused conditional (#3) launches on the "
        f"RBF + Linear serving path: {paths[-1][2]}")
    compare_paths(model_c)
    compare_factorizations(model_c)
    compare_gradients(model_c)

    trained = training_model()
    paths.append(train(trained, gpu, ADAM_STEPS, (NAT_STEPS_1, NAT_STEPS_2),
                       MASKED_STEPS))
    compare_gradients(trained)
    trained_nw = training_model(white=False)
    paths.append(train(trained_nw, gpu, NONWHITE_ADAM_STEPS,
                       NONWHITE_NAT_STEPS))
    off_prior = training_model(white=False)
    perturb(off_prior, np.random.default_rng(3))
    compare_gradients(off_prior)
    compare_factorizations(off_prior, gradients=True)
    trained_c = training_model(composite=True)
    paths.append(train(trained_c, gpu, COMPOSITE_ADAM_STEPS,
                       COMPOSITE_NAT_STEPS))

    paths.append(run_bo(gpu))
    launched, model_mf = run_mf(gpu)
    paths.append(launched)
    compare_mf(model_mf)
    launched, model_em = run_em(gpu)
    paths.append(launched)
    compare_em(model_em)
    paths.append(run_exact_mf(gpu, model_mf, model_em))
    paths.append(run_mf_bo(gpu))
    mo_err = check_mo_kernels()
    err_qf, err_qf_bwd = max(err_qf, mo_err[0]), max(err_qf_bwd, mo_err[1])
    err_chol = [max(err_chol[0], mo_err[2]), max(err_chol[1], mo_err[3])]
    launched, model_mo = run_mo(gpu)
    paths.append(launched)
    paths.append(run_mo_restarts(gpu))
    compare_mo(model_mo)
    mo_bo_err = check_mo_bo_kernels()
    err_qf, err_qf_bwd = max(err_qf, mo_bo_err[0]), max(err_qf_bwd, mo_bo_err[1])
    err_chol = [max(err_chol[0], mo_bo_err[2]), max(err_chol[1], mo_bo_err[3])]
    paths.append(run_mo_bo(gpu))
    cls_err = check_cls_kernels()
    err_qf, err_qf_bwd = max(err_qf, cls_err[0]), max(err_qf_bwd, cls_err[1])
    err_chol = [max(err_chol[0], cls_err[2]), max(err_chol[1], cls_err[3])]
    launched, cls_models = run_cls(gpu)
    paths.append(launched)
    compare_cls(*cls_models)
    paths.append(run_parallel(gpu))
    ex_err = check_examples_kernels()
    err_qf, err_qf_bwd = max(err_qf, ex_err[0]), max(err_qf_bwd, ex_err[1])
    err_chol = [max(err_chol[0], ex_err[2]), max(err_chol[1], ex_err[3])]
    paths.append(run_examples(gpu))
    launches = [sum(c[k] for c in paths) for k in range(11)]
    log(f"[paths] launches on the main paths {COUNTED}: {tuple(launches)}")

    ms, plain_ms, bound, by, fp32_bound = time_kernel(0, HIDDEN, DIN, S * N_REQUEST, gpu)
    time_kernel(0, 1, HIDDEN, S * N_REQUEST, gpu)  # layer 2's shape
    for kind in (1, 2):                             # the Matern forms
        time_kernel(kind, HIDDEN, DIN, S * N_REQUEST, gpu)
    for kind in KINDS:                              # the training shape
        time_kernel(kind, HIDDEN, DIN, S * N_TRAIN, gpu)
    time_kernel(0, 1, HIDDEN, S * N_TRAIN, gpu)
    bwd = time_backward(0, HIDDEN, DIN, S * N_TRAIN, gpu)
    time_backward(0, 1, HIDDEN, S * N_TRAIN, gpu)
    gram = {"rbf": time_gram(cfr, HIDDEN, S * N_TRAIN, gpu),
            "white": time_gram(cf, HIDDEN, S * N_TRAIN, gpu)}
    time_gram(cfr, 1, S * N_TRAIN, gpu)
    qf = time_quadform(HIDDEN, S * N_REQUEST, gpu)
    time_quadform(1, S * N_REQUEST, gpu)
    time_quadform(HIDDEN, 10_000, gpu)  # a small n: where would plain win?
    qf_bwd = time_quadform(HIDDEN, S * N_TRAIN, gpu, backward=True)
    time_quadform(1, S * N_TRAIN, gpu, backward=True)
    fw = time_fused_white(HIDDEN, S * N_REQUEST, gpu)
    time_fused_white(1, S * N_REQUEST, gpu)
    time_fused_white(HIDDEN, S * N_TRAIN, gpu)  # the training shape
    time_fused_white(1, S * N_TRAIN, gpu)
    time_fused_white(HIDDEN, 10_000, gpu)  # a small n: where would plain win?
    time_fused_white(1, 10_000, gpu)
    fw_bwd = time_fused_white(HIDDEN, S * N_TRAIN, gpu, backward=True)
    time_fused_white(1, S * N_TRAIN, gpu, backward=True)
    time_backward(1, HIDDEN, DIN, S * N_TRAIN, gpu)   # the Matern forms
    time_backward(2, HIDDEN, DIN, S * N_TRAIN, gpu)
    chol7 = time_cholesky(1, M, False, gpu)   # a non-whitened layer's KL
    time_cholesky(2, M, False, gpu)           # the probe's shape
    chol8 = time_cholesky(2, M, True, gpu)    # the whitened models' Kuu stack
    time_cholesky(1, 8, False, gpu, "bo")     # the BO GPR's padded Gram
    time_cholesky(2, 8, True, gpu, "bo")      # the BO DGP's Kuu stack
    for name, stack, _ in exact_grams()[:2]:     # the engine's largest stacks
        time_cholesky(*stack[0].shape[:2], False, gpu, kuu=name,
                      stack=stack[0])
    time_cholesky_variants(trained, gpu)
    time_steps(trained, gpu)
    time_steps(trained_nw, gpu, nat=False)
    time_steps(trained_c, gpu, nat=False)
    Xr = np.random.default_rng(2).uniform(0, 1, size=(N_REQUEST, DIN))
    profile_run("one whitened request", lambda: model.predict_y(Xr, S), gpu)
    profile_run("three whitened Adam steps", lambda: trained.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    profile_run("one non-whitened request", lambda: model_nw.predict_y(Xr, S),
                gpu)
    profile_run("three non-whitened Adam steps", lambda: trained_nw.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    profile_run("one RBF + Linear request", lambda: model_c.predict_y(Xr, S),
                gpu)
    profile_run("three RBF + Linear Adam steps", lambda: trained_c.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    time_mf(model_mf, gpu)
    time_em(model_em, gpu)
    time_mo(model_mo, gpu)
    time_cls(cls_models, gpu)
    time_engine(gpu)

    source = "dgp_tpu_torch/csrc/conditional_fused_rbf.cu"
    qf_source = "dgp_tpu_torch/csrc/quadform.cu"
    fw_source = "dgp_tpu_torch/csrc/conditional_fused.cu"
    phase_b = [{
        "name": f"{name}_gram",
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": err_gram[key],
        "ms": gram[key][0],
        "plain_ms": gram[key][1],
        "bound_ms": gram[key][2],
        "bound_by": gram[key][3],
        "library_ms": None,
    } for name, src, replaces, k, key in [
        ("conditional_fused_rbf_bwd", source,
         "dgp_tpu/ops/conditional_fused_rbf.py:145", 8, "rbf"),
        ("conditional_fused_bwd", fw_source,
         "dgp_tpu/ops/conditional_fused.py:87", 9, "white")]]
    kernels = [{
        "name": "conditional_fused_rbf",
        "route": "cuda",
        "source": source,
        "replaces": "dgp_tpu/ops/conditional_fused_rbf.py:131",
        "launches": launches[0],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
        "fp32_bound_ms": fp32_bound,
    }, {
        "name": "conditional_fused_rbf_bwd",
        "route": "cuda",
        "source": source,
        "replaces": "dgp_tpu/ops/conditional_fused_rbf.py:145",
        "launches": launches[1],
        "max_abs_err": err_bwd,
        "ms": bwd[0],
        "plain_ms": bwd[1],
        "bound_ms": bwd[2],
        "bound_by": bwd[3],
        "library_ms": None,
    }, {
        "name": "quadform",
        "route": "cuda",
        "source": qf_source,
        "replaces": "dgp_tpu/ops/quadform_pallas.py:103",
        "launches": launches[4],
        "max_abs_err": err_qf,
        "ms": qf[0],
        "plain_ms": qf[1],
        "bound_ms": qf[2],
        "bound_by": qf[3],
        "library_ms": None,
        "fp32_bound_ms": qf[4],
    }, {
        "name": "quadform_bwd",
        "route": "cuda",
        "source": qf_source,
        "replaces": "dgp_tpu/ops/quadform_pallas.py:117",
        "launches": launches[5],
        "max_abs_err": err_qf_bwd,
        "ms": qf_bwd[0],
        "plain_ms": qf_bwd[1],
        "bound_ms": qf_bwd[2],
        "bound_by": qf_bwd[3],
        "library_ms": None,
        "phase_b_launches": launches[10],
    }, {
        "name": "conditional_fused",
        "route": "cuda",
        "source": fw_source,
        "replaces": "dgp_tpu/ops/conditional_fused.py:72",
        "launches": launches[2],
        "max_abs_err": err_fw,
        "ms": fw[0],
        "plain_ms": fw[1],
        "bound_ms": fw[2],
        "bound_by": fw[3],
        "library_ms": None,
        "fp32_bound_ms": fw[4],
    }, {
        "name": "conditional_fused_bwd",
        "route": "cuda",
        "source": fw_source,
        "replaces": "dgp_tpu/ops/conditional_fused.py:87",
        "launches": launches[3],
        "max_abs_err": err_fw_bwd,
        "ms": fw_bwd[0],
        "plain_ms": fw_bwd[1],
        "bound_ms": fw_bwd[2],
        "bound_by": fw_bwd[3],
        "library_ms": None,
    }, {
        "name": "cholesky",
        "route": "cuda",
        "source": "dgp_tpu_torch/csrc/cholesky.cu",
        "replaces": "benchmarks/chol_probe.py:54",
        "launches": launches[6],
        "max_abs_err": err_chol[0],
        "ms": chol7[0],
        "plain_ms": chol7[1],
        "bound_ms": chol7[2],
        "bound_by": chol7[3],
        "library_ms": chol7[4],
    }, {
        "name": "cholesky_inverse",
        "route": "cuda",
        "source": "dgp_tpu_torch/csrc/cholesky.cu",
        "replaces": "benchmarks/chol_probe.py:99",
        "launches": launches[7],
        "max_abs_err": err_chol[1],
        "ms": chol8[0],
        "plain_ms": chol8[1],
        "bound_ms": chol8[2],
        "bound_by": chol8[3],
        "library_ms": chol8[4],
    }, *phase_b]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# -- steps: one checkout's Adam steps and #1-#4's host cost --------------------


def host_us(fn, reps=50):
    """Host µs per call of ``fn``: the time for the call to return with the
    card idle before it. The launches are asynchronous, so this is the
    host's own work. Median of ``reps`` calls."""
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    sync()
    return 1e6 * sorted(times)[reps // 2]


def plan_widths():
    """The widest D that each whitened kernel's plan takes at M = 128 (#1
    and #2 at Din = 8): the forwards' and backwards' size gates."""
    from dgp_tpu_torch.ops import conditional_fused as cf
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr

    widest = lambda ok: max(D for D in range(1, 257) if ok(D))
    return (f"#1 {widest(lambda D: cfr.supported(M, DIN, D))}, "
            f"#2 {widest(lambda D: cfr.backward_supported(M, DIN, D))}, "
            f"#3 {widest(lambda D: cf.supported(M, D))}, "
            f"#4 {widest(lambda D: cf.backward_supported(M, D))} (Din = {DIN})")


def steps_main(tree):
    """``python3 chip_smoke.py --steps [TREE]``: drive the port of the
    checkout at TREE (by default the one beside this script), so that two
    commits can be timed in turns in one call: the widest D that the plans
    of #1-#4 take at M = 128 (:func:`plan_widths`); the host µs per call of
    the wrappers of #1-#6 at the layer-1 training shape; the wall ms per
    Adam step of bench.py's whitened RBF, RBF + Linear and non-whitened
    models (and per Adam + natural-gradient step of the whitened one), with
    the device time of three Adam steps of each; and the wall ms of
    100,000-row requests of the non-whitened serving model, with the device
    time of one. Prints no result line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if tree is not None:
        sys.path.insert(0, os.path.abspath(tree))
    from dgp_tpu_torch.ops import conditional_fused as cf
    from dgp_tpu_torch.ops import conditional_fused_rbf as cfr
    from dgp_tpu_torch.ops import quadform as qf

    gpu = gpu_line()
    log(f"[steps] the port at {os.path.dirname(cf.__file__)} ({gpu})")
    log(f"[steps] widest D at M = {M}: {plan_widths()}")
    n = S * N_TRAIN
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    g = [torch.randn((n, HIDDEN), generator=gen, device=DEVICE) for _ in range(2)]
    rbf = fused_inputs(0, HIDDEN, M, DIN, n, 12, DEVICE)
    white = composite_inputs(HIDDEN, M, DIN, n, 14)
    Sq, A, g2, _ = quadform_inputs(HIDDEN, M, n, 13, DEVICE)
    with torch.no_grad():
        us = {"#1": host_us(lambda: cfr._launch(0, *rbf)),
              "#3": host_us(lambda: cf._launch(*white)),
              "#5": host_us(lambda: qf._launch(Sq, A, False)),
              "#2": host_us(lambda: cfr._launch_backward(0, *rbf, *g)),
              "#4": host_us(lambda: cf._launch_backward(*white, *g)),
              "#6": host_us(lambda: qf._launch_backward(Sq, A, g2, None))}
    log(f"[steps] host µs per forward and backward call (D={HIDDEN} M={M} "
        f"Din={DIN} n={n}, median of 50 with the card idle before each): "
        + ", ".join(f"{k} {v:.1f}" for k, v in us.items()) + f" ({gpu})")
    trained = training_model()
    trained_c = training_model(composite=True)
    trained_nw = training_model(white=False)
    time_steps(trained, gpu, rounds=5)
    time_steps(trained_c, gpu, rounds=5, nat=False)
    time_steps(trained_nw, gpu, rounds=5, nat=False)
    profile_run("three whitened Adam steps", lambda: trained.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    profile_run("three RBF + Linear Adam steps", lambda: trained_c.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    profile_run("three non-whitened Adam steps", lambda: trained_nw.optimize_adam(
        iterations=3, messages=0, shrink_inner=False), gpu)
    model_nw = serving_model(white=False)
    Xr = np.random.default_rng(2).uniform(0, 1, size=(N_REQUEST, DIN))
    request = lambda: model_nw.predict_y(Xr, S)
    request()
    ms = sorted(1e3 * timed(request)[1] for _ in range(5))
    log(f"[steps] non-whitened request (N={N_REQUEST}, S={S}), wall ms over 5: "
        f"{', '.join(f'{t:.2f}' for t in ms)} ({gpu})")
    profile_run("one non-whitened request", request, gpu)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--steps"]:
        sys.exit(steps_main(sys.argv[2] if len(sys.argv) > 2 else None))
    sys.exit(main())
