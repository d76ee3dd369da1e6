#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vihds_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing lines of its own:

1. the card's name and power limit (``nvidia-smi``), and whether the figures'
   packages (matplotlib, seaborn, tensorboard) import;
2. the build of every CUDA kernel under ``vihds_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), its time and ptxas report;
3. for each of the six fused kinds (``dr``, ``dr_prec``, ``relay``,
   ``relay_prec``, ``degrader``, ``degrader_prec``; its operands from the
   model and spec that feed it, theta drawn from the prior), all three
   methods: the forward kernel against its plain PyTorch version at the
   serving chunk (B=36 series x K=1000 samples), each state group against its
   own tolerance, with its time, the plain version's time and its bound; the
   backward kernel at the training shape (B=36 x K=200) with a seeded random
   cotangent, read per constant, state and row of the weight matrix against
   the plain version in float64 beside the plain version in float32, with
   its time, the plain version's time and its bound; the same on the
   operands one kernel-route training step of the kind's spec hands the
   backward (``step_operands``: its cotangent, mostly exact zeros, over
   the method's trajectory; elements whose float64 value lies below
   float32's normal range are read by the normwise limit only), with the
   cotangent's zero share, the time and two runs bit-equal; the forward held
   against its plain version and timed at the training shape too, and its
   first R - 12 rows run alone (a ragged last block) must equal those rows
   of the whole run bit for bit; two runs of a forward must give the same
   trajectory bit for bit at both shapes, and two of a ``_prec`` backward
   the same weight cotangent; then the backward's block per method and the
   forward's (rows, threads, shared memory, registers, blocks resident per
   SM, waves at each shape); then the
   black-box kernels
   (``blackbox_fwd``, ``blackbox_bwd``; operands from ``dr_blackbox_icml``),
   the forward against its plain version at the serving chunk and at the
   training shape, two forward runs bit-equal, the forward's block per
   method (threads, shared memory, blocks resident per SM, waves at both
   shapes), the backward per weight leaf, constant and state row against
   float64 run on the plain float32 sweep's relu masks, two backward runs
   bit-equal in dW, its time on a training step's operands, and the
   backward's block; 3f, the weighted kernels' fold axis (``dr_prec``,
   ``blackbox``) at 4 folds of the training shape: one launch against 4
   launches on each fold's slice and F=1 against the launch without the
   axis, bit for bit forward and backward, the fold launch against its plain
   version, and the times of one launch and of the 4;
4. serving ``dr_constant_icml`` at full width: three ``predict`` requests at
   K=1000 with ``eval_solver: pallas_midpoint``, one with a counterfactual,
   with the kernel's launch count; 4b, the kernel route held against the
   generic solver on a small input; 4c, a profile of one request;
5. training ``dr_constant_icml``: ``run_xval.run_on_split`` with ``solver:
   pallas_midpoint`` for 4 epochs (7 optimizer steps of B=36 x K=200 each,
   evaluation every 2 epochs at K=200 on the train split and K=1000 on the
   valid split), the xval artifacts, the step times and the kernels' launch
   counts (the backward once per step); 5b, one step through the kernels
   held against the plain online log-likelihood route on a small input; 5c,
   a profile of one step; 5d, k-fold cross-validation through ``call_run_xval.execute``,
   4 folds of 2 epochs, its merged xval artifacts; 5e, the same with
   ``--vmap_folds`` (all 4 folds in one batched step): the artifacts, each
   fold's ELBOs against 5d's, the ``dr`` kernels' launches against 5d's over
   4, the median batched step, one step's device busy time and the wall
   beside 5d's; 5f, one epoch of ``--vmap_folds`` on
   ``dr_constant_precisions`` and ``dr_blackbox_icml`` (the weighted
   kernels' fold axis on the training path) with their launches; 5g, the
   ``run_xval`` CLI at phase 5's configuration (a spec copy under ``solver:
   pallas_midpoint``) over several processes (``vihds_tpu_torch.parallel``),
   each rank a process of its own (``rank_main``): (a) two ranks sharing the
   card over gloo, ``--mesh_sample 2``, twice, and (b) one rank over NCCL,
   ``--mesh auto``; each rank's first line (its backend), its ``dr``
   launches, rows a launch, median step wall beside phase 5's and time a
   step in collectives; rank 0 alone writing (one experiment directory with
   ``completed.txt``, nothing beside the ranks); (a)'s artifacts against
   phase 5's (``xval_elbo`` rtol 1e-4, ``q_values`` and ``iw_predict_mu``
   rtol 2e-3 atol 2e-4), its two runs' ``xval_elbo`` bit-equal, (b)'s
   against phase 5's bit for bit (any value that differs is named);
6. serving ``dr_constant_precisions`` as phase 4 (three requests, one with a
   counterfactual), and one request of ``dr_constant_precisions_v2``;
7. training ``dr_constant_precisions`` as phase 5 (the precision nets'
   weights must move), 7b and 7c as 5b and 5c;
8. serving ``relay_constant_precisions`` (its 96-series CSV, three 36-row
   chunks, with a counterfactual); 8b, the kernel route against the generic
   solver; 8d, the plain ``relay`` kind through ``OdeModel.simulate`` of a
   directly built ``Relay_Constant`` (no shipped spec names it), forward and
   gradient, against the generic solver, with its kernels' launch counts;
9. training ``relay_constant_precisions`` as phase 7 (2 steps per epoch,
   T=99), 9b and 9c as 7b and 7c;
10. serving ``degrader_constant_precisions`` (two CSVs of its device, a
   counterfactual that sets Ara), 10b and 10d as 8b and 8d with
   ``Degrader_Constant``;
11. training ``degrader_constant_precisions`` (T=135), 11b and 11c;
12. serving ``dr_blackbox_icml`` as phase 4 (the black-box forward kernel),
   12b and 12c as 4b and 4c;
13. training ``dr_blackbox_icml`` as phase 7 (both nets' weights must
   move), 13b and 13c;
14. training ``dr_constant_icml_unmerged`` (``merge: false``: each of its six
   files on its own grid, five of 100 points and one of 86; the encoder reads
   every series on the 86-point grid) through ``run_on_split`` with ``solver:
   pallas_midpoint``, 2 epochs of 8 steps (the files in turn, B=36 x K=200),
   evaluation after each at K=200 / 1000, file by file, and a checkpoint after
   each: the step walls, the kernels' launch counts (the backward once per
   step), the xval artifacts; 14b as 5b on the first file's 100-point grid;
   14c the ``dr`` kernels on the operands of one training step on that grid
   (T=100) against their plain versions, timed;
15. serving from phase 14's checkpoint through ``predict.main --checkpoint``
   (one request at K=1000, ``eval_solver: pallas_midpoint``): the npz's
   arrays finite, its checkpoint epoch, the restored params bit-equal to the
   trained ones, and ``predict`` on them in memory bit-equal in its
   predictions, with the kernel's launches;
16. the models no fused kind covers (``auto_constant(_precisions)``,
   ``debug``, ``prpr_constant(_precisions)``,
   ``inducer_constant_precisions``, ``dr_growthrate_xval``, on its first
   CSV: ``ZOO_FIRST_FILE``), each trained
   for one epoch at its own solver and widths with a checkpoint and served
   one ``predict.main --checkpoint`` request at K=1000 on its own CSV, with
   the step and request walls; 16b ``dr_growthrate`` under ``solver:
   pallas_midpoint``: no kernel launched in a training step, and its
   trajectory bit-equal to the generic midpoint solver's;
17. training ``dr_constant_icml`` with ``--dreg`` (one forward and two
   backward pulls a step) through ``run_on_split`` under ``solver:
   pallas_midpoint``, 2 epochs of 7 steps at B=36 x K=200, evaluated as
   phase 5: the step walls beside phase 5's, the kernels' launch counts (the
   backward once per pull that reaches the ODE: ``dreg_pulls``) and the
   profile of one DReG step; 17b, one DReG step through the kernels held
   against the plain fold route on a small input for ``dr_constant_icml``,
   the three ``_precisions`` specs and ``dr_blackbox_icml``, with the
   backward's launches per step; 17c, ``dr_bwd``, ``dr_prec_bwd`` and
   ``blackbox_bwd`` on the operands each pull of one DReG step hands them,
   against the float64 plain sweep, with the cotangent's zero and subnormal
   shares and the time of each pull;
18. ``run_on_split`` with ``--profile_dir``: one Chrome trace, of epoch 2,
   whose kernel events name the fused forward and backward; 18b,
   ``run_xval.main`` with ``--plot_epoch 2`` and, where the figures'
   packages import, ``--figures`` (the event files and the xval figures);
   where one does not, the run says so once and still writes its ``xval_*``
   set, and ``--figures`` stops before training, naming the package;
19. path (a): ``dr_constant_icml`` under ``solver: dopri5`` (the adaptive
   forward, ``ops/dopri.py``, and the continuous adjoint's backward,
   ``ops/adjoint.py``; no kernel) through ``run_on_split`` on its first CSV,
   one epoch of 2 steps at B=36 x K=200 evaluated at K=200 / 1000, with its
   step times;
   the steps one forward takes per interval on a training step's operands,
   accepted and rejected, and whether an interval hit its cap (the model's
   own right-hand side under a counting wrapper); one ``predict`` request at
   K=1000 on the trained params; and one epoch with ``--dreg``; 19b, one
   training step on 4 series x 50 samples: the dopri5 adjoint's gradient
   against the fold route's rk4 gradient, and ``adjoint_solver: true``
   midpoint against the fold route's midpoint, each leaf within 5e-2 of its
   largest entry; 19c, the fold-stacked dopri5 forward (``folds=4``: a step
   controller per fold) on 4 folds' training-step operands of phase 19's
   model, each B=36 x K=200 (R = 28,800 rows), against each fold alone: each
   fold's attempted and accepted steps per interval equal, its trajectory
   within rtol 1e-4 atol 1e-6 (and whether bit-equal), the walls; 19d,
   ``call_run_xval --vmap_folds`` on phase 19's configuration, 4 folds x 1
   epoch at K=200 / 200, its artifacts, and the first batched step's loss
   of each fold against that fold's own step on the same u (rtol 1e-5);
20. path (c): ``run_inference_graph`` on the demo graph (auto -> prpr -> dr,
   the ``*_constant_precisions`` models at the graph's own samples) with
   epochs cut to 2 and 2 folds a node, its ``dr`` node under ``solver:
   pallas_midpoint`` (the ``dr_prec`` kernels' launches counted): each
   downstream ``propagatedParams.txt`` held against mu and sigma recomputed
   from its upstream's ``xval_q_*`` files, then a second run that skips all
   three nodes; 20b, ``--jobs 2`` on two same-stage ``dr_constant_icml``
   nodes (kernel route, 1 epoch, 2 folds) in spawn workers on the one card;
   20c, the simulator (``simulate.main``) at the recovery study's flags (48
   series a device, sigma_scale 0.5, calibration to a probe peak of 1.0 in
   200 Adam steps, blocked rejection) on ``dr_constant_precisions`` (the
   ``dr_prec`` kernels, max_scaled 2.0) and ``dr_constant_icml`` (the ``dr``
   kernels, max_scaled 3.0: its probe cannot peak below e, ``SIM_RUNS``),
   each under ``solver: pallas_midpoint``: the launches (the backward once
   per calibration step, the forward's count accounted for), the walls of
   calibration, rejection and writing, the kernel-route decode of the
   accepted theta against the plain generic midpoint decode, the CSV
   reloaded through ``build_datasets``, the global sites shared, the
   peaks, and the calibration's backward on its own operands
   (``check_calibration``: the gradient of the probe's peak in the shared
   center at g = 0 and at the calibrated center, through the kernels
   against the plain route in float64 at phase 3's backward limits: a
   one-hot cotangent at the peak, the calibration's own ``torch.max``, a
   dense cotangent over all 288 rows); 20d, the JAX package's recorded truths
   (``reports/recovery_study`` and ``reports/recovery_precisions``) decoded
   again through ``dr_fwd`` and ``dr_prec_fwd`` against their recorded
   x_noiseless and precisions; 20e, ``recovery_study.main`` on
   ``dr_constant_one`` under ``solver: pallas_midpoint`` at its widths, its
   depth cut (``STUDY_DEPTH``: 400 of its 1000 epochs, K 200 / 1000, 48
   series; HMC stage 3b, ``hmc_refine`` on the local sites, 64 chains x 60
   of its 200 steps, R = 3,072 rows a launch, and 3c, ``hmc_refine_pooled``,
   32 x 90 of its 300, R = 1,536): the headline, the stages'
   readings, the tool's recovery.npz keys and REPORT sections, the wall
   and the ``dr`` kernels' launches, each equal to the count of the
   simulator, the training steps, the evaluation chunks and the stages
   (``sampler_launches``), then ``check_sampler`` on each stage (its
   launches; the z-gradient of the log-joint through the kernels against
   the plain route in float64 at the chains' first and last z; the backward
   on the last gradient's dense operands against the float64 sweep, its
   zero share and time beside the bound; two runs of
   the stage's seed, steps cut to 2, bit-equal), then ``check_calibration``
   on its design (R = 48: the last 32-row block half full); 20f and 20g, the
   study's stages 2-3 with both HMC stages (``train_and_score``), their
   depth cut (``RECORDED_STUDIES``: 300 / 125 training epochs, 40 / 60
   and 100 / 150 HMC steps) on the
   JAX package's recorded simulations under ``reports/recovery_study``
   (``dr``) and ``reports/recovery_precisions`` (288 series, ``dr_prec`` at
   R = 18,432 and 9,216), each headline and
   the stages' acceptance, cover95, ESS, R-hat and displacement beside the
   recorded report's (recorded at 1,000 / 2,000 and 200 / 300 steps), the
   same checks as 20e; 20h, the other samplers on 20e's trained model at
   the tools' widths, steps cut to ~50 (``OTHER_SAMPLERS``): ``smc_refine``
   64 particles x 8 temperatures x 2 moves and ``hmc_refine`` 64 chains x
   30 steps on 12 series, ``gibbs_refine_pooled`` 16 chains x 50 sweeps
   and ``pm_refine_shared`` 16 chains x 64 particles x 50 steps (forward
   only, R = 49,152) on 48, each with ``check_sampler`` (the
   pseudo-marginal sampler's log-likelihood against float64 instead of a
   gradient); 20i, serving and refinement over the mesh's ranks
   (``refine_rank_main``): 2 gloo ranks sharing the card run
   ``predict.main --mesh_sample 2`` on phase 14's checkpoint (one request
   at K=1000) and then ``hmc_refine`` (64 chains x 10 steps) and
   ``smc_refine`` (64 particles x 4 temperatures x 2 moves) on 12 of its
   series over a (1, 2) mesh, beside the one-process reference in a third
   process: each rank's ``dr`` launches and rows a launch against the
   prediction, rank 0 alone writing, the npz bit-equal to the reference's
   but for the moments (summed over K in halves: rtol 1e-5 atol 1e-6), the
   samplers' outputs of both ranks bit-equal to the reference's; 20j-20n,
   the research tools (``vihds_tpu_torch.tools``), each on a copy of its
   spec under ``solver: pallas_midpoint``, each run's ``dr`` launches
   against the count of its training steps, evaluation chunks and
   samplers (``sampler_launches``), their depth cut (``TOOLS_DEPTH``): 20j
   ``refine_demo`` on phase 14's checkpoint at its own depth (IWAE at K =
   64, SMC 16 x 2 and HMC 60 steps on 12 series, R = 768), every printed
   number finite; 20k ``ar_mu_ground_truth run`` through the per-series
   route and the pooled Gibbs route, their npz with the recorded keys, and
   ``report`` over them beside a copy of ``reports/ar_mu_ground_truth_r5``;
   20l ``icml_site_mechanism`` ``ridge`` (R = 3,744) and ``drift``; 20m
   ``posterior_parity ours`` for 2 seeds, ``compare --against`` the
   recorded ``reports/posterior_parity_ctrl_unit`` (the q-site names and
   shapes the recorded ones, the recorded files untouched) and
   ``clip_activity``; 20n ``xval_plotting`` on phase 18b's artifacts
   (without matplotlib it stops naming the package and writes nothing);
21. the total time, the wall of each group of phases, the depth cuts, one
   line with the readings of phases 19-20n, and the
   ``kernels`` JSON line (every row with ``launches_vmap``, its launches
   on phases 5e-5f's ``--vmap_folds`` paths, null where none ran it; the
   ``dr_prec`` and ``blackbox`` rows with phase 3f's fold launch times
   ``vmap_fold``; the ``dr`` rows with the
   launches of phases 14-15 and the times of 14c; the ``dr``, ``dr_prec``
   and ``blackbox`` backward rows with the DReG pulls' launches, times and
   subnormal shares of 17b-17c; the ``dr`` rows with
   ``launches_distributed``, each rank's launches in 5g's layouts, and
   ``launches_refine_mesh``, each rank's launches on 20i's paths, and
   ``launches_tools``, the launches of each run of 20j-20m; the
   ``dr`` and ``dr_prec`` rows with
   ``launches_simulate`` (20c), ``launches_recovery`` (20e, null for
   ``dr_prec``), ``launches_recorded_study`` (20f, 20g) and
   ``launches_refine`` (each HMC path's launches by phase and stage or
   sampler, 20e-20h), their forward rows with ``launches_recorded_truth``
   (20d) and their backward rows with ``refine_operands`` (the backward on
   each path's dense operands: zero share, readings, time, bound)), then
   the last line ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero; it also exits non-zero,
printing no result, where CUDA is not available or the package is missing.
It imports nothing of JAX and nothing of ``vihds_tpu``.
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SPEC = os.path.join(HERE, "specs", "dr_constant_icml.yaml")
SPEC_PREC = os.path.join(HERE, "specs", "dr_constant_precisions.yaml")
SPEC_PREC_V2 = os.path.join(HERE, "specs", "dr_constant_precisions_v2.yaml")
SPEC_RELAY = os.path.join(HERE, "specs", "relay_constant_precisions.yaml")
SPEC_DEGRADER = os.path.join(HERE, "specs", "degrader_constant_precisions.yaml")
SPEC_BB = os.path.join(HERE, "specs", "dr_blackbox_icml.yaml")
SPEC_UNMERGED = os.path.join(HERE, "specs", "dr_constant_icml_unmerged.yaml")
#: the specs of the models that no fused kind covers, each served from its
#: own CSV (the first of ``data: files`` with rows of its devices)
ZOO_SPECS = ["auto_constant.yaml", "auto_constant_precisions.yaml", "debug.yaml",
             "prpr_constant.yaml", "prpr_constant_precisions.yaml",
             "inducer_constant_precisions.yaml", "dr_growthrate_xval.yaml"]
#: phase 16: the zoo specs trained on their first CSV only (their epoch's
#: depth cut to keep the script's time: dr_growthrate_xval's six files made
#: 7 steps of ~1.8 s on the generic solver, the first makes 2)
ZOO_FIRST_FILE = ("dr_growthrate_xval.yaml",)
SPEC_GROWTH = os.path.join(HERE, "specs", "dr_growthrate_xval.yaml")
REQUESTS = ["proc141021.csv", "proc141023.csv", "proc141028.csv"]
COUNTERFACTUAL = "C6=25000;C12=0"
RELAY_REQUESTS = ["proc_Relays_RemovedOutlier.csv"]
DEGRADER_REQUESTS = ["proc_degrader_RemovedDuplicates.csv", "proc_PBadAiia_Ara_C6C12.csv"]
DEGRADER_COUNTERFACTUAL = "Ara=5"
#: the spec whose model feeds each kind its operands in phase 3 (the plain
#: relay / degrader kinds take the species of the precisions models')
KIND_SPEC = {"dr": SPEC, "dr_prec": SPEC_PREC, "relay": SPEC_RELAY, "relay_prec": SPEC_RELAY,
             "degrader": SPEC_DEGRADER, "degrader_prec": SPEC_DEGRADER}
K_SERVE = 1000
K_TRAIN = 200
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# float32 operations per sample row, counted from csrc/dr_common.cuh (an
# expf, a tanhf or a division counts as one), of one right-hand side and of
# one right-hand side pullback of each family.  dr: 59 and 157 (31 to
# recompute the core's terms, 126 to pull back); relay adds 20 for its four
# rows and 80 for their pullback; degrader 9 and 26.
RHS_FLOPS = {"dr": 59, "relay": 59 + 20, "degrader": 59 + 9}
VJP_FLOPS = {"dr": 157, "relay": 157 + 80, "degrader": 157 + 26}


def prec_block_flops(ns):
    """(right-hand side, pullback) operations of the precision block over
    ``ns`` species: ns + 1 tanhf, 8 dot products of length 2 + ns at 2 flop
    a term, 8 sigmoids at 4, 8 for dprec; the pullback recomputes all but the
    dprec, then 40 for dp, dd and dprec, 32 (2 + ns) for the dW and df
    accumulations and 4 ns for the species' share (209 and 593 at ns = 8)."""
    forward = (ns + 1) + 16 * (2 + ns) + 32
    return forward + 8, forward + 40 + 32 * (2 + ns) + 4 * ns


def bb_flops():
    """(right-hand side, pullback) operations per sample row of the
    black-box nets at the kernels' widths (an expf or a division counts as
    one; a sigmoid is 4).  Per net with input n_in, hidden width H and n_out
    outputs: the right-hand side is 2 n_in H + 2 H (bias, relu) + 4 H n_out
    + 2 n_out (biases) + 8 n_out (sigmoids) + 2 n_out; the pullback, given
    the activations the right-hand side computed, is 9 n_out for the output
    layer's cotangents, 4 H n_out + H for dh and dah, 2 m H for the cotangent
    of the m inputs that get one (all 27 of each net: the precision net's
    time input gets none), and the weights' share summed over the rows, a
    multiply-add per weight and an add per bias (3,455 over both nets)."""
    nets = ((27, 25, 6, 27), (28, 20, 4, 27))  # (n_in, H, n_out, inputs pulled back)
    rhs = sum(2 * n * h + 2 * h + 4 * h * o + 12 * o for n, h, o, _ in nets)
    pull = sum(9 * o + 4 * h * o + h + 2 * m * h + 2 * (n * h + 2 * h * o) + h + 2 * o
               for n, h, o, m in nets)
    return rhs, pull


def bb_step_flops(S):
    """(forward, backward) operations of one fixed-grid step per sample row
    of the black-box kernels for each method: the forward as ``step_flops``;
    the backward as the function needs it, each stage's right-hand side once
    (2 for modeuler and midpoint, 4 for rk4) and one pullback through each
    stage with its activations, plus the state updates of ``step_flops``.
    csrc/blackbox_bwd.cu recomputes each stage's activations once more in its
    pullback; that is the kernel's own cost, not the function's, and the
    bound leaves it out."""
    rhs, pull = bb_flops()
    fwd = step_flops(rhs, pull, S)[0]
    bwd = {"modeuler": 2 * (rhs + pull) + 2 + 9 * S, "midpoint": 2 * (rhs + pull) + 2 + 7 * S,
           "rk4": 4 * (rhs + pull) + 4 + 21 * S}
    return fwd, bwd


def step_flops(rhs, vjp, S):
    """(forward, backward) operations of one fixed-grid step per sample row
    for each method, from a right-hand side's and a pullback's: the
    right-hand sides (and pullbacks) a step evaluates, and each method's
    state updates, forward 2 + 5 S / 3 + 4 S / 5 + 13 S, backward 2 + 9 S /
    2 + 7 S / 4 + 21 S (modeuler / midpoint / rk4) for S states."""
    fwd = {"modeuler": 2 * rhs + 2 + 5 * S, "midpoint": 2 * rhs + 3 + 4 * S,
           "rk4": 4 * rhs + 5 + 13 * S}
    bwd = {"modeuler": rhs + 2 * vjp + 2 + 9 * S, "midpoint": rhs + 2 * vjp + 2 + 7 * S,
           "rk4": 3 * rhs + 4 * vjp + 4 + 21 * S}
    return fwd, bwd


def flops_per_step(kind):
    """``step_flops`` of a fused kind of ``fused_ode.KINDS``."""
    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    family = kind[: -len("_prec")] if k.prec else kind
    rhs, vjp = RHS_FLOPS[family], VJP_FLOPS[family]
    if k.prec:
        b_rhs, b_vjp = prec_block_flops(k.n_species)
        rhs, vjp = rhs + b_rhs, vjp + b_vjp
    return step_flops(rhs, vjp, k.n_states)


# kernel vs plain PyTorch: the kernel contracts a*b+c into FMAs and the two
# evaluate expf differently, each step rounding differently from the plain
# version; over the grid's steps the states then differ by float32 rounding
# only
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# the precision states of the _prec kinds, held on their own.  They start
# near e^6 ~ 400 and span ~0.2 to ~1e4; their dynamics dprec = sigmoid(.) -
# sigmoid(.) prec contract, so the kernel's tanhf / expf, which differ from
# PyTorch's by float32 ulps, leave them within float32 rounding too (the
# TPU's approximate tanh / sigmoid moved them by up to 2e-2,
# pallas_ode.py:268-273; the card's are accurate to a few ulps).  Their
# smallest values are ~0.2, so an absolute floor matters little
PREC_RTOL, PREC_ATOL = 1e-4, 1e-5
# the relay and degrader kinds' C6 and C12, which no row of the right-hand
# side reads: they start at the treatments (0 to 2.5e4) and integrate
# KC rc x luxI / (1 + luxI / Klux) (relay) or x rC aiiA (degrader, with
# aiiA of either sign, so on prior draws they reach ~1e9 and cross zero).
# An element near a crossing carries the rounding of the trajectory's
# largest values: there the plain version in float32 is itself off from
# float64 by more than the species rule.  So each sample row's trajectory
# of each is held against its own largest magnitude
SIGNAL_STATES = {"relay": (10, 11), "degrader": (9, 10)}
SIGNAL_RTOL, SIGNAL_ATOL = 1e-4, 1e-5
# the degrader_prec precision nets read tanh(C6), tanh(C12): where a signal
# crosses zero its rounding flips that feature between -1 and 1, which moves
# the precision states by more than their own rounding (the plain version in
# float32 is off from float64 by about the element rule on prior draws).
# Its precision states are held against each trajectory's largest magnitude
# too, with PREC_RTOL / PREC_ATOL
PREC_OVER_T = ("degrader_prec",)
# a backward kernel vs its plain version run in float64 on the same operands
# (see cotangent_readings): each constant row of dc, each state row of dy0
# and each row of dW is held on its own, by its largest error over its
# largest value across the R sample rows (or the row's weights), and by the
# 99th percentile of its elements' relative errors (float32 sums over the
# grid's steps cancel, so a few elements near zero may be off by more).  The
# plain version run in float32 is held to the same limits in the same run,
# and phase 3 prints its readings beside the kernel's: the limits stand well
# above them
BWD_NORM_TOL, BWD_P99_TOL = 1e-4, 1e-3
# On a training step's operands (step_operands) some samples' cotangents lie
# below float32's normal range: there float32 keeps no relative accuracy,
# and on dr_prec's the plain float32 sweep itself misses the percentile
# limit (phase 3 prints its reading over every element).  Those elements are read by the normwise
# limit alone there (cotangent_readings' normal_only); the limits are the
# same
FLT_MIN = 2.0 ** -126
# the black-box backward is held to the same limits, against the plain sweep
# in float64 run on the relu masks of the plain float32 sweep (ReluMasks):
# where a hidden unit's pre-activation lies within float32 rounding of 0 a
# float64 recompute of the same stored trajectory may take the other side of
# the kink, and that unit's whole share then moves its row.  Phase 3 counts
# those units and prints the kernel's reading against the float64 sweep on
# its own masks beside it.  The plain float32 sweep's readings are printed
# beside the kernel's, not held: its weight leaves are PyTorch's reductions
# over all rows, and the 99th percentile of a leaf of 80 entries is near its
# largest relative error, that of an entry the sum over rows cancels to near
# 0 (midpoint's precisions/prod/w reads ~1.0e-3 on the card)
# kernel route vs the generic Python-stepped solver, through the whole
# serving forward (the weights exponentiate log-likelihoods of ~1e4 nats,
# so the per-item ELBO is compared in absolute nats)
ROUTE_RTOL, ROUTE_ATOL = 1e-3, 1e-4
ELBO_ATOL = 0.5
# the batched folds' ELBO lists against the sequential folds' (phase 5e):
# the JAX package's limit for its vmapped folds (tests/test_run_xval.py)
VMAP_ELBO_RTOL = 1e-3
# one training step, kernel route vs the plain fold route on the card: the
# loss (~1e5 nats at random weights for dr_constant_icml, ~1e2 for the
# models whose precisions are states) sums the same float32 terms in another
# order, and each gradient leaf (or theta's gradient in phases 8d, 10d) is
# compared by the norm of its difference
LOSS_ATOL, GRAD_RTOL = 1.0, 1e-3
# the continuous adjoint's gradient against the fold route's (phase 19b):
# each leaf within this share of its largest entry (the adjoint's backward
# re-integrates on RK4 substeps; tests/test_solvers.py holds its y0
# gradient at 5e-2 against backprop through rk4)
ADJOINT_RTOL = 5e-2


def fail(msg):
    print("chip_smoke: FAILED: " + msg, file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` calls, timed with CUDA
    events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_card():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print("phase 1: card name, power limit (nvidia-smi):")
    print(line)
    from vihds_tpu_torch.utils import FIGURE_PACKAGES, missing_packages

    missing = missing_packages(FIGURE_PACKAGES)
    print("phase 1: the figures' packages: %s"
          % ", ".join("%s %s" % (name, "missing" if name in missing else "imports")
                      for name in FIGURE_PACKAGES))
    return line


def phase_build():
    from vihds_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build()
    seconds = time.perf_counter() - t0
    for name, log in sorted(logs.items()):
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "entry function" in ln:
                print("  %s ptxas: %s" % (name, ln.strip()))
    print("phase 2: built %s in %.2f s" % (sorted(build.SOURCES), seconds))


def serving_setup(device, eval_solver="pallas_midpoint", spec=SPEC):
    """The port's model of ``spec`` (dr_constant_icml unless named) with
    seeded random params."""
    import torch

    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.predict import create_parser
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.vae import VAE

    args = create_parser().parse_args([spec, "--data", REQUESTS[0], "--seed", str(SEED)])
    settings = Config(args)
    settings.params.eval_solver = eval_solver
    data = build_datasets(args, settings)
    program = ParamProgram(parse_parameters(settings.params))
    model = VAE(settings, data, program)
    params = model.init_params(torch.Generator().manual_seed(SEED), device=device)
    return args, settings, data, program, model, params


def _prior_theta(device, program, model, params, ds, rows, K, seed):
    """theta drawn from the prior for the train split's ``rows`` at K
    samples, clipped and conditioned as the decoder sees it.  Returns (theta
    dict, inputs, dev_1hot, times)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    times = torch.as_tensor(ds.times, dtype=torch.float32, device=device)
    inputs = torch.as_tensor(ds.inputs[rows], dtype=torch.float32, device=device)
    dev_1hot = torch.as_tensor(ds.dev_1hot[rows], dtype=torch.float32, device=device)
    u = model.sample_u(gen, inputs.shape[0], K, device)
    theta = program.clip(program.sample(program.prior_q(device), u))
    th = model.ode_model.condition_theta(params["dec"], program.theta_dict(theta), dev_1hot)
    return th, inputs, dev_1hot, times


def kind_inputs(device, kind, K, seed):
    """The operands of ``kind``'s kernels for one n_batch-row chunk of
    ``KIND_SPEC[kind]``'s model at K samples: theta from the prior, turned
    into the kernels' constants and initial states, i.e. the inputs the
    serving and training paths hand the kernels, in the prior's range, with
    the model's seeded random precision nets.  Returns (constants dict,
    precision params, y0 [B, K, S], wmat [8, 2 + NS], packed [NC, R], y0
    [S, R], times); the precision params and wmat are None for a plain
    kind."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    _, settings, data, program, model, params = serving_setup(device, spec=KIND_SPEC[kind])
    B = settings.params.n_batch
    ode = model.ode_model
    with torch.no_grad():
        th, inputs, _, times = _prior_theta(device, program, model, params, data.train.dataset,
                                            slice(0, B), K, seed)
        consts = ode._pallas_constants(th, inputs)
        y0 = ode.initialize_state(params["dec"], th, inputs, B, K)
        y0 = torch.broadcast_to(y0, (B, K, y0.shape[-1]))[..., : k.n_states].contiguous()
    prec_params = params["dec"]["precisions"] if k.prec else None
    wmat = fused_ode._prec_wmat(prec_params) if k.prec else None
    packed, y0_cols = fused_ode._pack(consts, y0, kind)
    return consts, prec_params, y0, wmat, packed, y0_cols, times


def captured_step(device, module, name, spec):
    """The arguments, detached, of the one call to ``module.<name>`` (a
    backward kernel's launch function) in one kernel-route training step of
    ``spec``'s model at B=36 series x K=200 samples, with the seeded params
    and draws of ``one_step``: the operands a training step hands the
    kernel."""
    import torch

    captured = []
    launch = getattr(module, name)

    def capture(*args):
        captured.append([x.detach() if isinstance(x, torch.Tensor) else x for x in args])
        return launch(*args)

    setattr(module, name, capture)
    try:
        _, _, _, step = one_step(device, TRAIN_SOLVER, range(36), K_TRAIN, SEED + 7, spec)
        step()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, launch)
    if len(captured) != 1:
        fail("a training step of %s called %s %d times" % (spec, name, len(captured)))
    return captured[0]


_STEP_OPERANDS = {}


def step_operands(device, kind):
    """The operands one kernel-route training step of ``KIND_SPEC[kind]``'s
    model hands the kind's backward kernel (``captured_step`` at
    ``fused_ode.kind_bwd``): (wmat or None, packed [NC, R], times, y0 [S, R],
    its trajectory cotangent g [T, S, R], most of it exactly zero).  The
    plain relay / degrader kinds, which no shipped spec trains, take their
    ``_prec`` kind's constants and the species rows of its y0 and g.  The
    caller integrates the trajectory from y0 with the method it holds the
    kernel in."""
    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    source = kind if k.prec or kind == "dr" else kind + "_prec"
    if source not in _STEP_OPERANDS:
        got, wmat, packed, times, traj, g, _ = captured_step(device, fused_ode, "kind_bwd",
                                                             KIND_SPEC[source])
        if got != source:
            fail("a training step of %s launched %s, not %s" % (KIND_SPEC[source], got, source))
        _STEP_OPERANDS[source] = (wmat, packed, times, traj[0].contiguous(), g)
    wmat, packed, times, y0, g = _STEP_OPERANDS[source]
    if source != kind:
        return None, packed, times, y0[: k.n_states].contiguous(), g[:, : k.n_states].contiguous()
    return wmat, packed, times, y0, g


def bound(n_bytes, n_flops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 peak."""
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    flops_ms = 1e3 * n_flops / FP32_FLOPS_PER_S
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


#: calls of a plain version that phase 3 times: one, right after the
#: comparison that ran it on the same operands (not a median of 3 after a
#: warm-up: cut to keep the script within its time limit)
PHASE3_PLAIN_REPS = 1


def timed(kernel, plain, n_bytes, n_flops, reps=3):
    """A kernel's time (median of 20 launches), its plain version's (median
    of ``reps``, after a warm-up call where ``reps`` > 1) and the bound of
    the work: ``n_bytes`` moved, ``n_flops`` done."""
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, reps, warmup=1 if reps > 1 else 0)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=n_bytes, flops=n_flops)


def fwd_row(kind, wmat, packed, y0_cols, times, method):
    """The forward kernel's time, its plain version's time and its bound on
    these operands: each input read once, the trajectory written once."""
    from vihds_tpu_torch.ops import fused_ode

    R, T, S = packed.shape[1], times.shape[0], y0_cols.shape[0]
    n_w = wmat.numel() if wmat is not None else 0
    return timed(lambda: fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method),
                 lambda: fused_ode._plain_fwd(kind, wmat, packed, y0_cols, times, method),
                 4 * (n_w + packed.numel() + y0_cols.numel() + times.numel() + T * S * R),
                 flops_per_step(kind)[0][method] * (T - 1) * R, PHASE3_PLAIN_REPS)


def fwd_repeats(kind, wmat, packed, y0_cols, times, method):
    """True when two launches of ``kind``'s forward kernel give the same
    trajectory bit for bit."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    return bool(torch.equal(fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method),
                            fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)))


def print_block(device, kernel, method, block, row_counts):
    """Print a kernel's block for ``method`` (``block``: sample rows, threads,
    static shared memory, registers, blocks resident per SM) and its waves
    over the card's SMs at each of ``row_counts``; returns them as a dict."""
    import torch

    rows, threads, smem, regs, per_sm = block
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    waves = {R: -(-R // rows) / max(per_sm * sms, 1) for R in row_counts}
    print("  %-9s %s block: %d rows x %d threads, %d B of shared memory, %d registers, "
          "%d blocks (%d warps) resident per SM; %s"
          % (method, kernel, rows, threads, smem, regs, per_sm, per_sm * threads // 32,
             "; ".join("at R=%d %d blocks on %d SMs: %.2f waves" % (R, -(-R // rows), sms, w)
                       for R, w in waves.items())))
    return dict(rows=rows, threads=threads, shared_bytes=smem, registers=regs,
                blocks_per_sm=per_sm, waves={str(R): w for R, w in waves.items()})


def states_ok(got, ref, kind):
    """A forward trajectory [T, ..., S] of ``kind`` against the plain
    version's, each state group to its own tolerance: the species element by
    element, the signal states (``SIGNAL_STATES``) against each trajectory's
    largest magnitude over T, the precision states element by element (or,
    for a kind in ``PREC_OVER_T``, as the signals).  Returns ([max relative
    error of each group, None for a group the kind lacks], ok); where a
    group is held to its trajectories' scale, so is its relative error."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    signals = list(SIGNAL_STATES.get(kind[: -len("_prec")] if k.prec else kind, ()))
    species = [s for s in range(k.n_species) if s not in signals]
    out = []
    ok = bool(torch.isfinite(got).all())
    for idx, rtol, atol, scale_over_t in (
            (species, KERNEL_RTOL, KERNEL_ATOL, False),
            (signals, SIGNAL_RTOL, SIGNAL_ATOL, True),
            (list(range(k.n_species, k.n_states)), PREC_RTOL, PREC_ATOL,
             kind in PREC_OVER_T)):
        if not idx:
            out.append(None)
            continue
        a, b = got[..., idx], ref[..., idx]
        err = (a - b).abs()
        scale = b.abs().amax(dim=0, keepdim=True) if scale_over_t else b.abs()
        out.append(float((err / scale.clamp_min(1e-30)).max()))
        ok = ok and bool((err <= atol + rtol * scale).all())
    return out, ok


def cotangent_readings(got, ref, normal_only=False):
    """Per row of a backward output [n, R] against its float64 reference
    ``ref``: (normwise error, the largest |got - ref| over the largest
    |ref|; the 99th percentile of |got - ref| / |ref|), two float64 [n]
    tensors.  Each constant (and state) is read on its own: one sample row
    of dc spans many decades across the constants, and one constant's
    cotangent many decades across the samples.  With ``normal_only`` an
    element whose reference lies below float32's normal range (FLT_MIN),
    where a float32 result has no relative accuracy, counts as exact in the
    percentile and is held by the normwise reading alone."""
    import torch

    err = (got.double() - ref).abs()
    norm = err.amax(dim=1) / ref.abs().amax(dim=1).clamp_min(1e-300)
    rel = err / ref.abs().clamp_min(1e-300)
    if normal_only:
        rel = torch.where(ref.abs() < FLT_MIN, torch.zeros_like(rel), rel)
    return norm, rel.quantile(0.99, dim=1)


def cotangents_ok(got, ref, normal_only=False):
    """True when ``got`` is finite and every row is within BWD_NORM_TOL
    (normwise) and BWD_P99_TOL (99th percentile relative) of ``ref``
    (``cotangent_readings``)."""
    import torch

    norm, rel = cotangent_readings(got, ref, normal_only)
    return (bool(torch.isfinite(got).all()) and bool((norm <= BWD_NORM_TOL).all())
            and bool((rel <= BWD_P99_TOL).all()))


def _fmt(x):
    return "-" if x is None else "%.3e" % x


def phase_kind_kernels(device, kind, seed):
    """Phase 3 for one kind: its forward kernel against the plain version
    at the serving chunk and at the training shape, and its backward kernel
    at the training shape, all
    three methods (see the module's docstring).  Returns (forward rows at
    the serving chunk, backward rows, forward rows at the training shape),
    each {method: readings and times}."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    k = fused_ode.KINDS[kind]
    consts, prec_params, y0, wmat, packed, y0_cols, times = kind_inputs(device, kind, K_SERVE,
                                                                        seed)
    B = y0.shape[0]
    R, T, S = packed.shape[1], times.shape[0], k.n_states
    family = kind[: -len("_prec")] if k.prec else kind
    print("phase 3 (%s): %s vs plain PyTorch at B=%d K=%d (R=%d) T=%d; species rtol %g atol %g%s%s"
          % (kind, k.fwd, B, K_SERVE, R, T, KERNEL_RTOL, KERNEL_ATOL,
             ", signals %s rtol %g atol %g of each trajectory's largest |value|"
             % (list(SIGNAL_STATES[family]), SIGNAL_RTOL, SIGNAL_ATOL)
             if family in SIGNAL_STATES else "",
             ", precisions rtol %g atol %g%s" % (PREC_RTOL, PREC_ATOL,
                                                 " of each trajectory's largest |value|"
                                                 if kind in PREC_OVER_T else "")
             if k.prec else ""))
    fwd_rows = {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            got = fused_ode.simulate_kind(kind, consts, y0, times, method, prec_params)
            ref = fused_ode._simulate_plain(kind, consts, prec_params, y0, times, method)
            torch.cuda.synchronize()
            if tuple(got.shape) != (T, B, K_SERVE, S):
                fail("%s %s: shape %s" % (k.fwd, method, tuple(got.shape)))
            if not bool(torch.isfinite(ref).all()):
                fail("%s %s: the plain version is not finite on these inputs" % (k.fwd, method))
            (rel_x, rel_s, rel_p), ok = states_ok(got, ref, kind)
            same = fwd_repeats(kind, wmat, packed, y0_cols, times, method)
            r = fwd_rows[method] = dict(max_abs_err=float((got - ref).abs().max()),
                                        max_rel_species=rel_x, max_rel_signals=rel_s,
                                        max_rel_precisions=rel_p,
                                        **fwd_row(kind, wmat, packed, y0_cols, times, method))
            print("  %-9s max_rel_err species %s signals %s precisions %s (max_abs_err %.3e on "
                  "|ref| up to %.3e)%s  kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, "
                  "%d flop)  %s"
                  % (method, _fmt(rel_x), _fmt(rel_s), _fmt(rel_p), r["max_abs_err"],
                     float(ref.abs().max()),
                     " | repeat run bit-equal: %s" % same,
                     r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"], r["bytes"],
                     r["flops"], "ok" if ok else "MISMATCH"))
            if not ok:
                fail("%s %s disagrees with its plain version" % (k.fwd, method))
            if not same:
                fail("%s %s: two runs gave different trajectories" % (k.fwd, method))

    R_serve = R
    _, _, y0, wmat, packed, y0_cols, times = kind_inputs(device, kind, K_TRAIN, seed + 1)
    R = packed.shape[1]
    row_names = (list(k.names) + ["y0[%d]" % s for s in range(S)]
                 + (["W[%d,:]" % j for j in range(k.wmat_shape[0])] if k.prec else []))
    print("phase 3 (%s): %s vs plain PyTorch at B=%d K=%d (R=%d) T=%d, both read against the "
          "plain version in float64: every constant's and state's row over the samples%s, "
          "within %g normwise and %g at the 99th percentile of relative error"
          % (kind, k.bwd, B, K_TRAIN, R, T,
             ", and every row of the weight cotangent over its %d columns" % k.wmat_shape[1]
             if k.prec else "", BWD_NORM_TOL, BWD_P99_TOL))

    def rows_of(dw, dc, dy0):
        return [torch.cat([dc, dy0])] + ([dw] if k.prec else [])

    s_wmat, s_packed, s_times, s_y0, s_g = step_operands(device, kind)
    zero_share = float((s_g == 0).double().mean())
    subnormal_share = float(((s_g != 0) & (s_g.abs() < FLT_MIN)).double().mean())
    rows, train_fwd_rows, readings = {}, {}, {}
    with torch.no_grad():
        for method in fused_ode.METHODS:
            traj = fused_ode.kind_fwd(kind, wmat, packed, y0_cols, times, method)
            gen = torch.Generator(device=device).manual_seed(seed + 2)
            g = torch.randn(traj.shape, generator=gen, device=device)
            got = rows_of(*fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method))
            same = (not k.prec or bool(torch.equal(
                got[1], fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method)[0])))
            plain = rows_of(*fused_ode._plain_bwd(kind, wmat, packed, times, traj, g, method))
            ref = rows_of(*fused_ode._plain_bwd(
                kind, wmat.double() if k.prec else None, packed.double(), times.double(),
                traj.double(), g.double(), method))
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in ref):
                fail("%s %s: the plain version is not finite on these inputs" % (k.bwd, method))
            k_norm, k_rel = (torch.cat(x) for x in zip(*map(cotangent_readings, got, ref)))
            p_norm, p_rel = (torch.cat(x) for x in zip(*map(cotangent_readings, plain, ref)))
            readings[method] = (k_norm, k_rel, p_norm, p_rel)
            ok = all(map(cotangents_ok, got, ref))
            plain_ok = all(map(cotangents_ok, plain, ref))
            err = (got[0].double() - ref[0]).abs()
            # inputs read once (weights, constants, grid, traj, g), outputs
            # written once (dW, dc, dy0)
            n_w = wmat.numel() if k.prec else 0
            r = rows[method] = dict(
                max_abs_err=float(err.max()),
                max_rel_err=float((err / ref[0].abs().clamp_min(1e-300)).max()),
                worst_norm=float(k_norm.max()), worst_p99=float(k_rel.max()),
                plain_worst_norm=float(p_norm.max()), plain_worst_p99=float(p_rel.max()),
                **timed(lambda: fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method),
                        lambda: fused_ode._plain_bwd(kind, wmat, packed, times, traj, g, method),
                        4 * (2 * n_w + 2 * packed.numel() + times.numel() + 2 * T * S * R
                             + S * R),
                        flops_per_step(kind)[1][method] * (T - 1) * R, PHASE3_PLAIN_REPS))
            # the forward at this shape too: against its plain version, and
            # on the first R - 12 rows alone (a ragged last block), which
            # must give those rows of traj bit for bit
            fwd_ref = fused_ode._plain_fwd(kind, wmat, packed, y0_cols, times, method)
            (fx, fs, fp), fwd_ok = states_ok(traj.movedim(1, -1), fwd_ref.movedim(1, -1), kind)
            del fwd_ref
            n_edge = R - 12
            edge = bool(torch.equal(traj[:, :, :n_edge], fused_ode.kind_fwd(
                kind, wmat, packed[:, :n_edge].contiguous(), y0_cols[:, :n_edge].contiguous(),
                times, method)))
            f = train_fwd_rows[method] = fwd_row(kind, wmat, packed, y0_cols, times, method)
            same_fwd = fwd_repeats(kind, wmat, packed, y0_cols, times, method)
            print("  %-9s kernel: worst normwise %.3e (%s), worst p99 rel %.3e (%s); plain "
                  "float32: %.3e, %.3e | max_abs_err %.3e on |ref| up to %.3e%s  kernel %.4f ms  "
                  "plain %.2f ms  bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, r["worst_norm"], row_names[int(k_norm.argmax())], r["worst_p99"],
                     row_names[int(k_rel.argmax())], r["plain_worst_norm"],
                     r["plain_worst_p99"], r["max_abs_err"], float(ref[0].abs().max()),
                     ", repeat run dW bit-equal: %s" % same if k.prec else "", r["ms"],
                     r["plain_ms"], r["bound_ms"], r["bound_by"], r["bytes"], r["flops"],
                     "ok" if ok else "MISMATCH"))
            print("  %-9s %s at this shape: max_rel_err species %s signals %s precisions %s, "
                  "rows 0..%d alone bit-equal: %s%s  kernel %.4f ms  plain %.2f ms  bound %.4f ms "
                  "(%s)  %s"
                  % (method, k.fwd, _fmt(fx), _fmt(fs), _fmt(fp), n_edge - 1, edge,
                     ", repeat run bit-equal: %s" % same_fwd, f["ms"],
                     f["plain_ms"], f["bound_ms"], f["bound_by"], "ok" if fwd_ok else "MISMATCH"))
            if not ok:
                fail("%s %s disagrees with its plain version" % (k.bwd, method))
            if not plain_ok:
                fail("%s %s: the plain version in float32 is outside the tolerance itself"
                     % (k.bwd, method))
            if not same:
                fail("%s %s: two runs gave different weight cotangents" % (k.bwd, method))
            if not same_fwd:
                fail("%s %s: two runs gave different trajectories" % (k.fwd, method))
            if not fwd_ok:
                fail("%s %s disagrees with its plain version at B=%d K=%d"
                     % (k.fwd, method, B, K_TRAIN))
            if not edge:
                fail("%s %s: a ragged last block changed the trajectory" % (k.fwd, method))

            # a training step's own operands (step_operands): its cotangent
            # over this method's trajectory, held to the same limits
            s_traj = fused_ode.kind_fwd(kind, s_wmat, s_packed, s_y0, s_times, method)
            got = rows_of(*fused_ode.kind_bwd(kind, s_wmat, s_packed, s_times, s_traj, s_g,
                                              method))
            again = rows_of(*fused_ode.kind_bwd(kind, s_wmat, s_packed, s_times, s_traj, s_g,
                                                method))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            plain = rows_of(*fused_ode._plain_bwd(kind, s_wmat, s_packed, s_times, s_traj, s_g,
                                                  method))
            ref = rows_of(*fused_ode._plain_bwd(
                kind, s_wmat.double() if k.prec else None, s_packed.double(), s_times.double(),
                s_traj.double(), s_g.double(), method))
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in ref):
                fail("%s %s: the plain version is not finite on a training step's operands"
                     % (k.bwd, method))
            k_norm, k_rel = (torch.cat(x) for x in zip(*(cotangent_readings(a, b, True)
                                                          for a, b in zip(got, ref))))
            p_norm, p_rel = (torch.cat(x) for x in zip(*(cotangent_readings(a, b, True)
                                                          for a, b in zip(plain, ref))))
            ok = all(cotangents_ok(a, b, True) for a, b in zip(got, ref))
            plain_ok = all(cotangents_ok(a, b, True) for a, b in zip(plain, ref))
            plain_all_p99 = max(float(cotangent_readings(a, b)[1].max())
                                for a, b in zip(plain, ref))
            r.update(step_zero_share=zero_share, step_subnormal_share=subnormal_share,
                     step_max_abs_err=float((got[0].double() - ref[0]).abs().max()),
                     step_worst_norm=float(k_norm.max()), step_worst_p99=float(k_rel.max()),
                     step_ms=cuda_ms(lambda: fused_ode.kind_bwd(
                         kind, s_wmat, s_packed, s_times, s_traj, s_g, method), 20))
            print("  %-9s a training step's cotangent (%.4f of it exactly zero, %.4f subnormal), "
                  "elements below float32's normal range read normwise only: kernel: worst "
                  "normwise %.3e (%s), worst p99 rel %.3e (%s); plain float32: %.3e, %.3e (p99 "
                  "over every element %.3e) | repeat run bit-equal: %s  kernel %.4f ms (%.4f ms "
                  "on the random one)  %s"
                  % (method, zero_share, subnormal_share, r["step_worst_norm"],
                     row_names[int(k_norm.argmax())],
                     r["step_worst_p99"], row_names[int(k_rel.argmax())], float(p_norm.max()),
                     float(p_rel.max()), plain_all_p99, same, r["step_ms"], r["ms"],
                     "ok" if ok else "MISMATCH"))
            if not ok:
                fail("%s %s disagrees with its plain version on a training step's operands"
                     % (k.bwd, method))
            if not plain_ok:
                fail("%s %s: the plain version in float32 is outside the tolerance itself on a "
                     "training step's operands" % (k.bwd, method))
            if not same:
                fail("%s %s: two runs on a training step's operands differ" % (k.bwd, method))
    for method in fused_ode.METHODS:
        fwd_rows[method]["block"] = print_block(device, k.fwd, method,
                                                fused_ode.fwd_block(kind, method), (R, R_serve))
        rows[method]["block"] = print_block(device, k.bwd, method,
                                            fused_ode.bwd_block(kind, method), (R,))
    print("  per row, normwise error / 99th percentile relative error against float64, "
          "kernel then plain float32, for %s:" % ", ".join(fused_ode.METHODS))
    for i, name in enumerate(row_names):
        print("    %-9s" % name + "  |".join(
            " %.1e %.1e / %.1e %.1e" % tuple(float(x[i]) for x in readings[m])
            for m in fused_ode.METHODS))
    return fwd_rows, rows, train_fwd_rows


# the black-box kernels' state groups: the 4 observed and 2 latent species
# (they start at init_x and 0, and at 1e-3, and stay positive: dx =
# sigmoid(.) - sigmoid(.) x) and the 4 precision states (from 1e-5, the same
# form), each held element by element to the species' tolerance
BB_GROUPS = (("observed", 0, 4), ("latent", 4, 6), ("precisions", 6, 10))


def blackbox_inputs(device, K, seed):
    """The operands of the black-box kernels for one n_batch-row chunk of
    dr_blackbox_icml at K samples: theta from the prior, turned into the
    kernels' constants and initial states by the model, with the model's
    seeded random nets.  Returns (the decoder's params, constants [B, K, 21],
    y0 [B, K, 10], the packed [1760] weights, [21, R] constants, [10, R] y0,
    times, the leaves' shapes)."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox as fb

    _, settings, data, program, model, params = serving_setup(device, spec=SPEC_BB)
    B = settings.params.n_batch
    ode = model.ode_model
    with torch.no_grad():
        th, inputs, dev_1hot, times = _prior_theta(device, program, model, params,
                                                   data.train.dataset, slice(0, B), K, seed)
        consts = ode._constants(th, inputs, dev_1hot, K)
        y0 = ode.initialize_state(params["dec"], th, inputs, B, K)
    wv, wflat, packed, y0_cols = fb._pack(params["dec"], consts, y0)
    return (params["dec"], consts, y0, wflat, packed, y0_cols, times,
            tuple(tuple(w.shape) for w in wv))


def bb_states_ok(got, ref):
    """A black-box trajectory [T, ..., 10] against the plain version's:
    ([max relative error of each of ``BB_GROUPS``], ok)."""
    import torch

    out, ok = [], bool(torch.isfinite(got).all())
    for _, lo, hi in BB_GROUPS:
        a, b = got[..., lo:hi], ref[..., lo:hi]
        err = (a - b).abs()
        out.append(float((err / b.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((err <= KERNEL_ATOL + KERNEL_RTOL * b.abs()).all())
    return out, ok


def bb_fwd_row(wflat, packed, y0_cols, times, shapes, method):
    """blackbox_fwd's time, its plain version's and its bound on these
    operands: each input read once, the trajectory written once."""
    from vihds_tpu_torch.ops import fused_blackbox as fb

    R, T, S = packed.shape[1], times.shape[0], y0_cols.shape[0]
    wv = fb._split(wflat, shapes)
    return timed(
        lambda: fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, fb.KERNEL_N_STATES,
                                method),
        lambda: fb._plain_fwd(wv, packed, y0_cols, times, fb.KERNEL_N_STATES, method),
        4 * (wflat.numel() + packed.numel() + y0_cols.numel() + times.numel() + T * S * R),
        bb_step_flops(S)[0][method] * (T - 1) * R, PHASE3_PLAIN_REPS)


def bb_cotangent_readings(dw, dc, dy0, ref, shapes, normal_only=False):
    """A black-box backward's outputs (dW packed [1760], dc [21, R], dy0
    [10, R]) against the plain sweep's in float64 ``ref`` = (the 12 leaves,
    dc, dy0): the ``cotangent_readings`` of each constant's and state's row
    over the samples, then of each weight leaf over its entries, and whether
    every reading is within BWD_NORM_TOL / BWD_P99_TOL (``normal_only`` as
    in ``cotangent_readings``)."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox as fb

    rw, rc, ry = ref
    norm, rel = cotangent_readings(torch.cat([dc, dy0]), torch.cat([rc, ry]), normal_only)
    for a, b in zip(fb._split(dw, shapes), rw):
        n, p = cotangent_readings(a.reshape(1, -1), b.reshape(1, -1), normal_only)
        norm, rel = torch.cat([norm, n]), torch.cat([rel, p])
    finite = all(bool(torch.isfinite(x).all()) for x in (dw, dc, dy0))
    return norm, rel, (finite and bool((norm <= BWD_NORM_TOL).all())
                       and bool((rel <= BWD_P99_TOL).all()))


class ReluMasks:
    """The ``relu_mask`` of ``fused_blackbox._plain_bwd`` that records the
    masks a sweep takes, in their order; ``replay()`` returns one that hands
    them out in the same order to another sweep on the same operands and
    counts, per sample row, the hidden units whose own mask differs
    (``flips``)."""

    def __init__(self, recorded=None):
        self.recorded = [] if recorded is None else recorded
        self.flips, self._next = None, None if recorded is None else iter(recorded)

    def replay(self):
        return ReluMasks(self.recorded)

    def __call__(self, h):
        own = h > 0
        if self._next is None:
            self.recorded.append(own)
            return own
        mask = next(self._next)
        flips = (mask != own).sum(dim=0)
        self.flips = flips if self.flips is None else self.flips + flips
        return mask


def bb_references(wv, packed, times, traj, g, n_states, method):
    """The plain sweeps of the black-box backward on these float32 operands:
    (the float32 sweep's (dW leaves, dc, dy0); the float64 sweep on the
    float32 sweep's relu masks, the reference the kernel is held to; the
    float64 sweep on its own masks; the hidden units per sample row [R]
    whose float64 mask differs from the float32 one, over the whole sweep)."""
    from vihds_tpu_torch.ops import fused_blackbox as fb

    masks = ReluMasks()
    plain = fb._plain_bwd(wv, packed, times, traj, g, n_states, method, masks)
    f64 = ([w.double() for w in wv], packed.double(), times.double(), traj.double(),
           g.double(), n_states, method)
    replay = masks.replay()
    ref = fb._plain_bwd(*f64, replay)
    return plain, ref, fb._plain_bwd(*f64), replay.flips


def phase_blackbox_kernels(device, seed):
    """Phase 3 for the black-box kernels: the forward against its plain
    version at the serving chunk and at the training shape, the backward at
    the training shape against the plain sweep in float64 per weight leaf,
    constant row and state row (beside the plain float32 sweep's readings),
    and two backward runs bit-equal in dW; all three methods.  Returns
    (forward rows at the serving chunk, backward rows, forward rows at the
    training shape), each {method: readings and times}."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox as fb, fused_ode

    NS = fb.KERNEL_N_STATES
    fwd_rows, train_fwd_rows = {}, {}
    fwd_R = []
    for K, rows, seed_k in ((K_SERVE, fwd_rows, seed), (K_TRAIN, train_fwd_rows, seed + 1)):
        params, consts, y0, wflat, packed, y0_cols, times, shapes = blackbox_inputs(device, K,
                                                                                    seed_k)
        B, R, T = y0.shape[0], packed.shape[1], times.shape[0]
        fwd_R.append(R)
        print("phase 3 (blackbox): blackbox_fwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d; "
              "%s each rtol %g atol %g"
              % (B, K, R, T, "/".join(g for g, _, _ in BB_GROUPS), KERNEL_RTOL, KERNEL_ATOL))
        with torch.no_grad():
            for method in fused_ode.METHODS:
                got = fb.blackbox_simulate(params, consts, y0, times, NS, method)
                ref = fb.blackbox_simulate_plain(params, consts, y0, times, NS, method)
                torch.cuda.synchronize()
                if tuple(got.shape) != (T, B, K, NS + fb.N_PREC):
                    fail("blackbox_fwd %s: shape %s" % (method, tuple(got.shape)))
                if not bool(torch.isfinite(ref).all()):
                    fail("blackbox_fwd %s: the plain version is not finite on these inputs"
                         % method)
                rel, ok = bb_states_ok(got, ref)
                same = bool(torch.equal(
                    fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method),
                    fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method)))
                r = rows[method] = dict(max_abs_err=float((got - ref).abs().max()),
                                        max_rel=rel, bit_equal_repeat=same,
                                        **bb_fwd_row(wflat, packed, y0_cols, times, shapes,
                                                     method))
                print("  %-9s max_rel_err %s (max_abs_err %.3e on |ref| up to %.3e) | repeat run "
                      "bit-equal: %s  kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, %d "
                      "flop)  %s"
                      % (method, " / ".join(_fmt(x) for x in rel), r["max_abs_err"],
                         float(ref.abs().max()), same, r["ms"], r["plain_ms"], r["bound_ms"],
                         r["bound_by"], r["bytes"], r["flops"], "ok" if ok else "MISMATCH"))
                if not ok:
                    fail("blackbox_fwd %s disagrees with its plain version" % method)
                if not same:
                    fail("blackbox_fwd %s: two runs gave different trajectories" % method)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for method in fused_ode.METHODS:
        threads, smem, per_sm = fb.fwd_block(method)
        print("  %-9s blackbox_fwd block: %d rows x %d threads, %d B of shared memory, %d blocks "
              "(%d warps) resident per SM; %s"
              % (method, fb.FWD_ROWS, threads, smem, per_sm, per_sm * threads // 32, "; ".join(
                  "at R=%d %d blocks on %d SMs: %.2f waves"
                  % (R_, -(-R_ // fb.FWD_ROWS), sms, -(-R_ // fb.FWD_ROWS) / max(per_sm * sms, 1))
                  for R_ in sorted(fwd_R))))

    # the backward at the training shape (the operands of the last pass)
    leaves = ["/".join(x) for x in fb.WEIGHT_LEAVES]
    row_names = ["c[%d]" % j for j in range(packed.shape[0])] + ["y0[%d]" % s
                                                                  for s in range(NS + 4)]
    print("phase 3 (blackbox): blackbox_bwd vs plain PyTorch at B=%d K=%d (R=%d) T=%d, both read "
          "against the plain version in float64 on the plain float32 sweep's relu masks: every "
          "constant's and state's row over the samples and every weight leaf over its entries, "
          "within %g normwise and %g at the 99th percentile of relative error"
          % (B, K, R, T, BWD_NORM_TOL, BWD_P99_TOL))

    names = row_names + leaves
    rows, table = {}, {}
    wv = fb._split(wflat, shapes)
    s_wflat, s_packed, s_times, s_traj, s_g, _, _, _ = captured_step(device, fb, "blackbox_bwd",
                                                                     SPEC_BB)
    with torch.no_grad():
        for method in fused_ode.METHODS:
            traj = fb.blackbox_fwd(wflat, packed, y0_cols, times, shapes, NS, method)
            gen = torch.Generator(device=device).manual_seed(seed + 2)
            g = torch.randn(traj.shape, generator=gen, device=device)
            dw, dc, dy0 = fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method)
            same = bool(torch.equal(dw, fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS,
                                                        method)[0]))
            (pw, pc, py), ref, own, flips = bb_references(wv, packed, times, traj, g, NS, method)
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(x).all()) for x in (ref[1], ref[2], *ref[0])):
                fail("blackbox_bwd %s: the plain version is not finite on these inputs" % method)
            k_norm, k_rel, ok = bb_cotangent_readings(dw, dc, dy0, ref, shapes)
            p_norm, p_rel, plain_ok = bb_cotangent_readings(
                torch.cat([x.reshape(-1) for x in pw]), pc, py, ref, shapes)
            table[method] = (k_norm, k_rel, p_norm, p_rel)
            got = torch.cat([dc, dy0]).double()
            err = (got - torch.cat([ref[1], ref[2]])).abs()
            # the kernel against the float64 sweep on its own masks: its worst
            # constant or state row, the sample row where that row's error
            # peaks and the units flipped there; and its worst reading over
            # the sample rows where no unit flipped
            o_norm, _ = cotangent_readings(got, torch.cat([own[1], own[2]]))
            worst = int(o_norm.argmax())
            at = int((got[worst] - torch.cat([own[1], own[2]])[worst]).abs().argmax())
            calm = flips == 0
            c_norm = (cotangent_readings(got[:, calm], torch.cat([own[1], own[2]])[:, calm])[0]
                      if bool(calm.any()) else torch.full((1,), math.nan))
            # inputs read once (weights, constants, grid, traj, g), outputs
            # written once (dW, dc, dy0)
            S = NS + fb.N_PREC
            r = rows[method] = dict(
                max_abs_err=float(err.max()), worst_norm=float(k_norm.max()),
                worst_p99=float(k_rel.max()), plain_worst_norm=float(p_norm.max()),
                plain_worst_p99=float(p_rel.max()), plain_within_limits=plain_ok,
                dw_bit_equal=same, relu_flips=int(flips.sum()), rows_with_flips=int((~calm).sum()),
                own_masks_worst_norm=float(o_norm.max()), own_masks_worst_row=names[worst],
                flips_in_its_sample_row=int(flips[at]),
                own_masks_worst_norm_without_flips=float(c_norm.max()),
                **timed(lambda: fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, NS, method),
                        lambda: fb._plain_bwd(wv, packed, times, traj, g, NS, method),
                        4 * (2 * wflat.numel() + 2 * packed.numel() + times.numel()
                             + 2 * T * S * R + S * R),
                        bb_step_flops(S)[1][method] * (T - 1) * R, PHASE3_PLAIN_REPS))
            print("  %-9s kernel: worst normwise %.3e (%s), worst p99 rel %.3e (%s); plain "
                  "float32: %.3e, %.3e (within the limits: %s) | repeat run dW bit-equal: %s  "
                  "kernel %.4f ms  plain %.2f ms  bound %.4f ms (%s: %d B, %d flop)  %s"
                  % (method, r["worst_norm"], names[int(k_norm.argmax())], r["worst_p99"],
                     names[int(k_rel.argmax())], r["plain_worst_norm"], r["plain_worst_p99"],
                     plain_ok, same, r["ms"], r["plain_ms"], r["bound_ms"], r["bound_by"],
                     r["bytes"], r["flops"], "ok" if ok else "MISMATCH"))
            print("  %-9s relu units whose float64 mask differs from float32's: %d in %d of %d "
                  "sample rows; against the float64 sweep on its own masks the kernel reads "
                  "%.3e normwise at %s, whose largest error lies in a sample row with %d flipped "
                  "unit(s), and %.3e over the sample rows with none"
                  % (method, r["relu_flips"], r["rows_with_flips"], R, r["own_masks_worst_norm"],
                     r["own_masks_worst_row"], r["flips_in_its_sample_row"],
                     r["own_masks_worst_norm_without_flips"]))
            if not ok:
                fail("blackbox_bwd %s disagrees with its plain version" % method)
            if not same:
                fail("blackbox_bwd %s: two runs gave different weight cotangents" % method)
    # midpoint on a training step's own operands (captured_step), timed
    r = rows["midpoint"]
    r["step_zero_share"] = float((s_g == 0).double().mean())
    r["step_ms"] = cuda_ms(lambda: fb.blackbox_bwd(s_wflat, s_packed, s_times, s_traj, s_g, shapes,
                                                   NS, "midpoint"), 20)
    print("  midpoint  on a training step's operands (its cotangent %.4f exactly zero): kernel "
          "%.4f ms (%.4f ms on the random one)" % (r["step_zero_share"], r["step_ms"], r["ms"]))
    n_blocks = -(-R // fb.BWD_ROWS)
    for method in fused_ode.METHODS:
        threads, smem, per_sm = fb.bwd_block(method)
        print("  %-9s blackbox_bwd block: %d rows x %d threads, %d B of dynamic shared memory, "
              "%d blocks (%d warps) resident per SM; at R=%d %d blocks on %d SMs: %.2f waves"
              % (method, fb.BWD_ROWS, threads, smem, per_sm, per_sm * threads // 32, R, n_blocks,
                 sms, n_blocks / max(per_sm * sms, 1)))
    print("  per row and leaf, normwise error / 99th percentile relative error against "
          "float64, kernel then plain float32, for modeuler, midpoint, rk4:")
    for i, name in enumerate(names):
        print("    %-22s" % name + "  |".join(
            " %.1e %.1e / %.1e %.1e" % tuple(float(x[i]) for x in table[m])
            for m in fused_ode.METHODS))
    return fwd_rows, rows, train_fwd_rows


#: the folds of the fold-axis checks and of ``call_run_xval --vmap_folds``
VMAP_FOLDS = 4


def fold_operands(device, kind, f):
    """Fold ``f``'s operands of a fold-axis kernel (``dr_prec`` or
    ``blackbox``) at the training shape: its own chunk of theta drawn from
    the prior (seed ``SEED + 201 + f``) and the seeded nets' weights scaled
    by 1 + 0.1 f, so that no two folds share weights.  Returns (weights,
    packed [NC, R_f], y0 [S, R_f], times, the leaves' shapes or None)."""
    seed = SEED + 201 + f
    if kind == "blackbox":
        _, _, _, w, packed, y0, times, shapes = blackbox_inputs(device, K_TRAIN, seed)
    else:
        _, _, _, w, packed, y0, times = kind_inputs(device, kind, K_TRAIN, seed)
        shapes = None
    return (w * (1.0 + 0.1 * f)).contiguous(), packed, y0, times, shapes


def phase_fold_kernels(device):
    """Phase 3f: the fold grid axis of the weighted kernels (``dr_prec_fwd``
    / ``dr_prec_bwd``, ``blackbox_fwd`` / ``blackbox_bwd``) at the training
    shape of ``VMAP_FOLDS`` folds (R = 4 x 7,200): one launch on [F, ...]
    weights against F launches on each fold's slice, bit for bit in the
    trajectory and in dc, dy0 and dW; F = 1 (the axis on one fold's weights)
    against the launch without the axis, bit for bit; the fold launch's
    trajectory against its plain version within phase 3's limits; and each
    launch's time beside the F separate launches'.  Returns {kernel:
    {method: readings}}."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox as fb, fused_ode

    F = VMAP_FOLDS
    NS = fb.KERNEL_N_STATES
    out = {}
    for kind in ("dr_prec", "blackbox"):
        parts = [fold_operands(device, kind, f) for f in range(F)]
        times, shapes = parts[0][3], parts[0][4]
        wv = torch.stack([p[0] for p in parts]).contiguous()
        packed = torch.cat([p[1] for p in parts], dim=1).contiguous()
        y0 = torch.cat([p[2] for p in parts], dim=1).contiguous()
        R, T = packed.shape[1], times.shape[0]
        Rf = R // F
        if kind == "blackbox":
            def fwd(w, pk, y, m):
                return fb.blackbox_fwd(w, pk, y, times, shapes, NS, m)

            def bwd(w, pk, tr, g, m):
                return fb.blackbox_bwd(w, pk, times, tr, g, shapes, NS, m)

            def plain(w, pk, y, m):
                return fb._plain_fwd_flat(w, shapes, pk, y, times, NS, m)

            def close(got, ref):
                return bb_states_ok(got.movedim(1, -1), ref.movedim(1, -1))
        else:
            def fwd(w, pk, y, m):
                return fused_ode.kind_fwd(kind, w, pk, y, times, m)

            def bwd(w, pk, tr, g, m):
                return fused_ode.kind_bwd(kind, w, pk, times, tr, g, m)

            def plain(w, pk, y, m):
                return fused_ode._plain_fwd(kind, w, pk, y, times, m)

            def close(got, ref):
                return states_ok(got.movedim(1, -1), ref.movedim(1, -1), kind)
        print("phase 3f (%s): the fold axis, %d folds of B=36 x K=%d (R=%d = %d x %d), T=%d: "
              "one launch on [%d, ...] weights vs %d launches on each fold's slice; F=1 vs the "
              "launch without the axis; the fold launch vs its plain version (phase 3's limits)"
              % (kind, F, K_TRAIN, R, F, Rf, T, F, F))
        rows = out[kind] = {}
        for method in fused_ode.METHODS:
            with torch.no_grad():
                traj = fwd(wv, packed, y0, method)
                sep = [fwd(w, pk, y, method) for w, pk, y, _, _ in parts]
                sl = [slice(f * Rf, (f + 1) * Rf) for f in range(F)]
                fwd_same = all(torch.equal(traj[..., sl[f]], sep[f]) for f in range(F))
                fwd_one = bool(torch.equal(fwd(wv[:1], parts[0][1], parts[0][2], method), sep[0]))
                ref = plain(wv, packed, y0, method)
                errs, ok = close(traj, ref)
                del ref
                gen = torch.Generator(device=device).manual_seed(SEED + 301)
                g = torch.randn(traj.shape, generator=gen, device=device)
                dw, dc, dy0 = bwd(wv, packed, traj, g, method)
                parts_g = [g[..., sl[f]].contiguous() for f in range(F)]
                sep_b = [bwd(parts[f][0], parts[f][1], sep[f], parts_g[f], method)
                         for f in range(F)]
                bwd_same = all(torch.equal(dw[f], sep_b[f][0])
                               and torch.equal(dc[:, sl[f]], sep_b[f][1])
                               and torch.equal(dy0[:, sl[f]], sep_b[f][2]) for f in range(F))
                one_b = bwd(wv[:1], parts[0][1], sep[0], parts_g[0], method)
                bwd_one = (torch.equal(one_b[0][0], sep_b[0][0])
                           and torch.equal(one_b[1], sep_b[0][1])
                           and torch.equal(one_b[2], sep_b[0][2]))
                r = rows[method] = dict(
                    fwd_ms=cuda_ms(lambda: fwd(wv, packed, y0, method), 20),
                    fwd_separate_ms=cuda_ms(
                        lambda: [fwd(w, pk, y, method) for w, pk, y, _, _ in parts], 20),
                    bwd_ms=cuda_ms(lambda: bwd(wv, packed, traj, g, method), 20),
                    bwd_separate_ms=cuda_ms(
                        lambda: [bwd(parts[f][0], parts[f][1], sep[f], parts_g[f], method)
                                 for f in range(F)], 20),
                    fwd_bit_equal=fwd_same, bwd_bit_equal=bwd_same, fwd_f1_bit_equal=fwd_one,
                    bwd_f1_bit_equal=bool(bwd_one),
                    max_rel_err=max(e for e in errs if e is not None))
            print("  %-9s F=%d vs %d launches bit-equal: forward %s, backward (dW, dc, dy0) %s; "
                  "F=1 vs no axis bit-equal: forward %s, backward %s; vs plain max_rel_err %s  "
                  "%s; forward %.4f ms (%d separate: %.4f ms), backward %.4f ms (%d separate: "
                  "%.4f ms)"
                  % (method, F, F, fwd_same, bwd_same, fwd_one, bool(bwd_one),
                     "/".join(_fmt(e) for e in errs), "ok" if ok else "MISMATCH", r["fwd_ms"], F,
                     r["fwd_separate_ms"], r["bwd_ms"], F, r["bwd_separate_ms"]))
            if not ok:
                fail("%s %s: the fold launch disagrees with its plain version" % (kind, method))
            if not (fwd_same and bwd_same and fwd_one and bwd_one):
                fail("%s %s: the fold axis changed a fold's bits" % (kind, method))
    return out


def check_request(out, n_theta, n_states):
    m = out.merged
    B, S, T = out.host.observations.shape
    if not math.isfinite(m.elbo):
        fail("non-finite ELBO %r" % m.elbo)
    want = {
        "per_item_elbo": (B,),
        "q_mu": (B, n_theta),
        "q_prec": (B, n_theta),
        "iw_predict_mu": (B, 4, T),
        "iw_predict_std": (B, 4, T),
        "iw_states": (B, n_states, T),
        "iw_variance": (B, 4, T),
    }
    import numpy as np

    for k, shape in want.items():
        if m[k].shape != shape:
            fail("%s has shape %s, want %s" % (k, m[k].shape, shape))
        if not np.isfinite(m[k]).all():
            fail("%s is not finite" % k)
    for cf in out.counterfactuals:
        for k in ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance"):
            if cf[k].shape != want[k] or not np.isfinite(cf[k]).all():
                fail("counterfactual %s: %s bad (shape %s)" % (cf.spec, k, cf[k].shape))
    return B


def iw_state_count(ode):
    """The states of ``iw_states``: a mechanistic model's species, or all
    the ODE states the black-box nets model."""
    return getattr(ode, "n_states", ode.n_species)


def _counter(kernel):
    """The function whose ``launches`` attribute counts ``kernel``'s launches."""
    from vihds_tpu_torch.ops import fused_blackbox, fused_ode

    return {**fused_ode.COUNTERS, **fused_blackbox.COUNTERS}[kernel]


def serve(device, spec, files, phase, kernel, counterfactual=COUNTERFACTUAL):
    """``predict`` one request per CSV of ``files`` on ``spec``'s model at
    K=1000 through the kernels (``eval_solver: pallas_midpoint``), the first
    with ``counterfactual``.  Counts ``kernel``'s launches from 0; returns
    (launches, request walls, the first request's output)."""
    import torch

    from vihds_tpu_torch.predict import create_parser, predict

    _, settings, _, program, model, params = serving_setup(device, spec=spec)
    name = os.path.basename(spec)[: -len(".yaml")]
    print("phase %s: serving %s, K=%d, eval_solver=%s"
          % (phase, name, K_SERVE, settings.params.eval_solver))
    requests = []
    for i, f in enumerate(files):
        argv = [spec, "--data", f, "--test_samples", str(K_SERVE), "--seed", str(SEED)]
        if i == 0:
            argv += ["--treatments", counterfactual]
        requests.append(create_parser().parse_args(argv))

    _counter(kernel).launches = 0
    walls, outs = [], []
    for args in requests:
        t0 = time.perf_counter()
        out = predict(args, settings, params=params, device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs.append(out)
    launches = _counter(kernel).launches

    for args, out, wall in zip(requests, outs, walls):
        B = check_request(out, program.n_theta, iw_state_count(model.ode_model))
        print("  request %-36s %3d series  wall %.3f s  elbo %.3f%s"
              % (os.path.basename(args.data[0]), B, wall, out.merged.elbo,
                 "  + counterfactual %s" % args.treatments[0] if args.treatments else ""))
    print("  %s launches on the serving path of %s: %d" % (kernel, name, launches))
    if launches == 0:
        fail("the serving path of %s never launched %s" % (name, kernel))
    return launches, walls, outs[0]


def route_close(got, ref, family):
    """States [..., S, T] of the kernel route against the generic solver's
    (numpy): within ROUTE_RTOL / ROUTE_ATOL element by element, the family's
    signal states (``SIGNAL_STATES``) against each trajectory's largest
    magnitude over T.  Returns (the largest error over its scale, ok)."""
    import numpy as np

    scale = np.abs(ref)
    idx = list(SIGNAL_STATES.get(family, ()))
    if idx:
        scale[..., idx, :] = np.abs(ref[..., idx, :]).max(axis=-1, keepdims=True)
    err = np.abs(got - ref)
    ok = bool(np.isfinite(got).all() and (err <= ROUTE_ATOL + ROUTE_RTOL * scale).all())
    return float((err / np.maximum(scale, 1e-30)).max()), ok


def phase_route_check(device, served, spec=SPEC, phase="4b"):
    """The kernel route through OdeModel.simulate against the generic
    Python-stepped solver on a small input from the first request, with the
    same draws u."""
    import numpy as np
    import torch

    from vihds_tpu_torch.training import batch_tensors, eval_step

    host = served.host
    rows = np.arange(min(4, host.observations.shape[0]))
    results = {}
    for solver in ("pallas_midpoint", "midpoint"):
        _, _, _, program, model, params = serving_setup(device, eval_solver=solver, spec=spec)
        times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
        batch = batch_tensors(host, rows, times, device)
        u = torch.randn((len(rows), 50, program.n_theta),
                        generator=torch.Generator(device=device).manual_seed(SEED + 2),
                        device=device)
        with torch.no_grad():
            res = eval_step(model, program, params, batch, 50, u=u)
        results[solver] = {k: v.cpu().numpy() for k, v in res.items()}
    a, b = results["pallas_midpoint"], results["midpoint"]
    family = (model.ode_model.pallas_kinds or (None,))[0]
    np.testing.assert_allclose(a["iw_predict_mu"], b["iw_predict_mu"], rtol=ROUTE_RTOL,
                               atol=ROUTE_ATOL, err_msg="iw_predict_mu")
    rel, ok = route_close(a["iw_states"], b["iw_states"], family)
    if not ok:
        fail("phase %s: iw_states of the kernel route disagree with the generic solver's (%.3e)"
             % (phase, rel))
    np.testing.assert_allclose(a["per_item_elbo"], b["per_item_elbo"], rtol=0, atol=ELBO_ATOL)
    print("phase %s: %s kernel route == generic midpoint solver on %d series x 50 samples "
          "(iw moments rtol %g atol %g%s, per-item ELBO within %g nats; max ELBO diff %.3e)"
          % (phase, os.path.basename(spec)[: -len(".yaml")], len(rows), ROUTE_RTOL, ROUTE_ATOL,
             ", signal states %s of each trajectory's largest |value|"
             % list(SIGNAL_STATES[family]) if family in SIGNAL_STATES else "",
             ELBO_ATOL, float(np.abs(a["per_item_elbo"] - b["per_item_elbo"]).max())))


def phase_plain_kind(device, spec, model_cls, phase):
    """The plain kind of ``spec``'s family (``relay`` / ``degrader``, which
    no shipped spec names) through ``OdeModel.simulate`` of a ``model_cls``
    built from the spec's settings, as the JAX package's tests build it: on
    the train split's first 4 rows x 50 prior draws, the trajectory and the
    gradient of a seeded weighted sum of it with respect to theta, through
    the kernels (``pallas_midpoint``) and through the generic midpoint
    solver.  The kernels' counts run from 0 over this path.  Returns their
    launches {kernel: n}."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    _, settings, data, program, model, params = serving_setup(device, spec=spec)
    ode = model_cls(settings)
    k = fused_ode.KINDS[ode.pallas_kinds[0]]
    ds = data.train.dataset
    with torch.no_grad():
        gen = torch.Generator(device=device).manual_seed(SEED + 11)
        u = model.sample_u(gen, 4, 50, device)
        theta = program.clip(program.sample(program.prior_q(device), u))
    inputs = torch.as_tensor(ds.inputs[:4], dtype=torch.float32, device=device)
    dev_1hot = torch.as_tensor(ds.dev_1hot[:4], dtype=torch.float32, device=device)
    times = torch.as_tensor(ds.times, dtype=torch.float32, device=device)
    weights = torch.randn((4, 50, ode.n_species, times.shape[0]), device=device,
                          generator=torch.Generator(device=device).manual_seed(SEED + 12))
    out = {}
    for solver in ("pallas_midpoint", "midpoint"):
        if solver == "pallas_midpoint":
            _counter(k.fwd).launches = 0
            _counter(k.bwd).launches = 0
        ode.solver = solver
        leaf = theta.clone().requires_grad_(True)
        th = ode.condition_theta(params["dec"], program.theta_dict(leaf), dev_1hot)
        sol = ode.simulate(params["dec"], th, times, inputs, dev_1hot, 50)
        (grad,) = torch.autograd.grad((sol * weights).sum(), leaf)
        torch.cuda.synchronize()
        if solver == "pallas_midpoint":
            launches = {k.fwd: _counter(k.fwd).launches, k.bwd: _counter(k.bwd).launches}
        out[solver] = (sol.detach(), grad)
    (sk, gk), (sg, gg) = out["pallas_midpoint"], out["midpoint"]
    sol_rel, sol_ok = route_close(sk.cpu().numpy(), sg.cpu().numpy(), k.name)
    ok = sol_ok and bool(torch.isfinite(gk).all())
    rel = float((gk - gg).norm() / gg.norm().clamp_min(1e-30))
    print("phase %s: %s (kind %s) built from %s's settings, 4 series x 50 samples: trajectory "
          "max rel diff %.3e vs the generic midpoint solver (rtol %g atol %g, signal states %s "
          "of each trajectory's largest |value|), theta gradient relative norm diff %.3e (tol "
          "%g); %s launches %d, %s launches %d"
          % (phase, model_cls.__name__, k.name, os.path.basename(spec)[: -len(".yaml")],
             sol_rel, ROUTE_RTOL, ROUTE_ATOL, list(SIGNAL_STATES[k.name]), rel, GRAD_RTOL,
             k.fwd, launches[k.fwd], k.bwd, launches[k.bwd]))
    if not (ok and rel <= GRAD_RTOL):
        fail("the %s kernel route disagrees with the generic solver" % k.name)
    if min(launches.values()) == 0:
        fail("the %s path did not launch %s" % (k.name, launches))
    return launches


def phase_profile(device, wall_s, spec=SPEC, phase="4c"):
    """Where one request's time goes: torch.profiler over the second
    request of ``spec``'s model (after the counted run), device time by
    kernel against the unprofiled wall time of the same request."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.predict import create_parser, load_new_data, predict
    from vihds_tpu_torch.training import Training

    _, settings, _, program, model, params = serving_setup(device, spec=spec)
    args = create_parser().parse_args(
        [spec, "--data", REQUESTS[1], "--test_samples", str(K_SERVE), "--seed", str(SEED)]
    )
    # the request's steps, timed one by one on the host clock
    t0 = time.perf_counter()
    data = build_datasets(args, settings)
    t1 = time.perf_counter()
    host = load_new_data(args.data, settings, data.train.dataset)
    t2 = time.perf_counter()
    Training(settings, data, program, model).evaluate(
        params, host, K_SERVE, torch.Generator(device=device).manual_seed(SEED), device,
        with_theta=False,
    )
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print("phase %s: request %s steps: build_datasets %.4f s, load_new_data %.4f s, "
          "evaluate %.4f s" % (phase, REQUESTS[1], t1 - t0, t2 - t1, t3 - t2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predict(args, settings, params=params, device=device)
        torch.cuda.synchronize()
    events, total_us = device_events(prof)
    if total_us == 0:
        print("phase %s: profiler saw no device time (device busy share: not measured)" % phase)
        return
    print("phase %s: request %s: %d kernel launches, device busy %.3f ms of %.3f ms "
          "unprofiled wall (busy share %.4f); top kernels by device time:"
          % (phase, REQUESTS[1], sum(e.count for e in events), total_us / 1e3, wall_s * 1e3,
             total_us / 1e6 / wall_s))
    for e in events[:8]:
        print("  %9.3f ms  %5d calls  %s" % (dev_us(e) / 1e3, e.count, e.key[:100]))


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_events(prof):
    """The kernels a profile saw (device-side events, the host-side aten ops
    that launched them carry the same time again), longest first, and
    their summed device microseconds."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    events.sort(key=dev_us, reverse=True)
    return events, sum(dev_us(e) for e in events)


TRAIN_FLAGS = ["--experiment", "chip_smoke", "--epochs", "4", "--test_epoch", "2",
               "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed", str(SEED)]
TRAIN_SOLVER = "pallas_midpoint"


def training_settings(solver=TRAIN_SOLVER, spec=SPEC, flags=TRAIN_FLAGS):
    """run_xval's args (``flags``) and settings for ``spec``
    (dr_constant_icml unless named), with ``solver`` set as phase 4 sets
    ``eval_solver`` (None: the spec's own)."""
    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Config

    args = run_xval.create_parser(True).parse_args([spec] + flags)
    settings = Config(args)
    if solver is not None:
        settings.params.solver = solver
    return args, settings


def train(device, spec, phase, fwd, bwd, flags=TRAIN_FLAGS, results_dir=None):
    """Train ``spec``'s model through run_on_split (``flags``: 4 epochs, eval
    every 2, K=200 / K=1000), write the xval artifacts as run_xval.main does,
    and count the launches of the kernels ``fwd`` and ``bwd`` from 0.  The
    results go to a temporary directory, or under ``results_dir``, which
    the caller removes."""
    import contextlib
    import statistics

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Trainer

    args, settings = training_settings(spec=spec, flags=flags)
    name = os.path.basename(spec)[: -len(".yaml")]
    with (contextlib.nullcontext(results_dir) if results_dir
          else tempfile.TemporaryDirectory()) as results_dir:
        os.environ["INFERENCE_RESULTS_DIR"] = results_dir
        settings.trainer = Trainer(args, add_timestamp=True)
        print("phase %s: training %s, split 1 of 4, solver %s, B=%d, K=%d, epochs %d, eval every "
              "%d at K=%d (train split) / %d (valid split)"
              % (phase, name, settings.params.solver, settings.params.n_batch, args.train_samples,
                 args.epochs, args.test_epoch, args.train_samples, args.test_samples))
        _counter(fwd).launches = 0
        _counter(bwd).launches = 0
        t0 = time.perf_counter()
        data, results, training = run_xval.run_on_split(args, settings, device=device)
        wall = time.perf_counter() - t0
        launches = {fwd: _counter(fwd).launches, bwd: _counter(bwd).launches}
        if results is None:
            fail("training left no best-validation results")
        run_xval.save_xval(args, settings, data, results)
        names = set(os.listdir(settings.trainer.tb_log_dir))
        cache = training.cache_dir
        n_xval = len([n for n in names if n.startswith("xval_")])
        if not os.path.isdir(cache) or n_xval != 16 or "completed.txt" not in names:
            fail("training artifacts missing: %s" % sorted(names))
        # what phase 5g holds its runs against
        training.xval = xval_arrays(settings.trainer.tb_log_dir)
    del os.environ["INFERENCE_RESULTS_DIR"]

    log = training.log_data
    elbos = log.training_elbo_list + log.validation_elbo_list + list(results.elbo_list)
    if not elbos or not all(math.isfinite(e) for e in elbos):
        fail("non-finite ELBOs %s" % elbos)
    steps = len(training.step_ms)
    spe = training.steps_per_epoch
    step_ms = statistics.median(training.step_ms[spe:])
    grids = sorted({len(host.times) for _, host, _ in training.train_groups}
                   if training.multi else [len(data.train.dataset.times)])
    print("  %d train / %d valid series, T=%s; %d optimizer steps (%d per epoch) in %.2f s wall; "
          "median step %.2f ms after the first epoch (first epoch's steps: %s ms)"
          % (data.n_train, data.n_test, "/".join(map(str, grids)), steps, spe, wall, step_ms,
             ", ".join("%.1f" % t for t in training.step_ms[:spe])))
    print("  best-val cache %s and %d xval_* files written" % (os.path.basename(cache), n_xval))
    print("  %s launches %d, %s launches %d (optimizer steps %d)"
          % (fwd, launches[fwd], bwd, launches[bwd], steps))
    pulls = dreg_pulls(training.final_params) if args.dreg else 1
    if steps != args.epochs * spe or launches[bwd] != pulls * steps:
        fail("%s launched %d times for %d optimizer steps of %d backward pull(s)"
             % (bwd, launches[bwd], steps, pulls))
    if launches[fwd] <= steps:
        fail("%s launched %d times: the evaluations did not take the kernel"
             % (fwd, launches[fwd]))
    return launches, step_ms, training


#: the xval arrays phase 5g compares
XVAL_COMPARED = ("elbo", "q_values", "iw_predict_mu")


def xval_arrays(run_dir):
    """``XVAL_COMPARED`` from a run directory's ``xval_*.npy`` (``q_values``
    flattened across its folds and sites)."""
    import numpy as np

    out = {n: np.load(os.path.join(run_dir, "xval_%s.npy" % n), allow_pickle=True)
           for n in XVAL_COMPARED}
    out["q_values"] = np.concatenate([np.ravel(np.asarray(v, np.float64))
                                      for v in out["q_values"]])
    out["iw_predict_mu"] = np.asarray(out["iw_predict_mu"], np.float64)
    out["elbo"] = np.asarray(out["elbo"], np.float64)
    return out


#: phase 5g: (label, ranks, flags) of each launch of the run_xval CLI over
#: processes; (a) twice, for repeatability
DIST_LAYOUTS = (("a", 2, ["--mesh_sample", "2"]), ("a2", 2, ["--mesh_sample", "2"]),
                ("b", 1, ["--mesh", "auto"]))
#: seconds a phase 5g launch may take before its ranks are killed
DIST_WALL = 400
#: the line a phase 5g rank prints its readings on
RANK_LINE = "phase 5g rank: "


def rank_main(argv):
    """One rank of phase 5g, run in a process of its own: ``run_xval.main``
    on ``argv`` (the card), the ``dr`` kernels' counts set to 0 just before
    it, then one ``RANK_LINE`` with this rank's launches, the rows of each
    launch, its steps' median wall after the first epoch, and each step's
    collectives (their count, and the median host time in them after the
    first epoch)."""
    import collections
    import statistics

    from vihds_tpu_torch import parallel, run_xval, training
    from vihds_tpu_torch.ops import fused_ode

    kept, snaps, in_steps = [], [], []
    rows = {"dr_fwd": collections.Counter(), "dr_bwd": collections.Counter()}
    run_on_split, train_epochs = run_xval.run_on_split, training.Training.train_epochs
    mark = training.Training._mark
    kind_fwd, kind_bwd = fused_ode.kind_fwd, fused_ode.kind_bwd

    def recorded_split(*a, **k):
        out = run_on_split(*a, **k)
        kept.append(out[2])
        return out

    def recorded_mark(cuda):
        snaps.append(dict(parallel.STATS))  # a mark starts a chunk and ends each step
        return mark(cuda)

    def recorded_steps(self, *a, **k):
        snaps.clear()
        out = train_epochs(self, *a, **k)
        in_steps.extend((b["collectives"] - a["collectives"], b["seconds"] - a["seconds"])
                        for a, b in zip(snaps, snaps[1:]))
        return out

    def fwd(kind, wmat, packed, *a):
        rows[kind + "_fwd"][int(packed.shape[1])] += 1
        return kind_fwd(kind, wmat, packed, *a)

    def bwd(kind, wmat, packed, *a):
        rows[kind + "_bwd"][int(packed.shape[1])] += 1
        return kind_bwd(kind, wmat, packed, *a)

    run_xval.run_on_split = recorded_split
    training.Training.train_epochs = recorded_steps
    training.Training._mark = staticmethod(recorded_mark)
    fused_ode.kind_fwd, fused_ode.kind_bwd = fwd, bwd
    for k in rows:
        _counter(k).launches = 0
    run_xval.main(argv)
    launches = {k: _counter(k).launches for k in rows}
    (trained,) = kept
    spe = trained.steps_per_epoch
    steps = len(trained.step_ms)
    print(RANK_LINE + json.dumps(dict(
        rank=int(argv[argv.index("--distributed") + 1].rsplit(",", 1)[1]),
        launches=launches,
        rows={k: {str(r): n for r, n in sorted(c.items())} for k, c in rows.items()},
        steps=steps, step_ms=statistics.median(trained.step_ms[spe:]),
        collectives_per_step=statistics.median(n for n, _ in in_steps),
        collective_ms_per_step=1e3 * statistics.median(t for _, t in in_steps[spe:]))),
        flush=True)
    return 0


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(spec, label, n, flags, directory):
    """``n`` rank processes of ``rank_main`` on ``spec`` with phase 5's
    flags and ``flags``, writing under ``directory/label`` from an empty
    working directory; killed all past ``DIST_WALL``.  Returns (each rank's
    stdout, the wall, the results directory, the working directory)."""
    results, cwd = os.path.join(directory, label), os.path.join(directory, label + "_cwd")
    os.makedirs(results)
    os.makedirs(cwd)
    port = _free_port()
    env = dict(os.environ, INFERENCE_RESULTS_DIR=results, PYTHONPATH=HERE)
    code = "import sys, chip_smoke; sys.exit(chip_smoke.rank_main(sys.argv[1:]))"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, spec] + TRAIN_FLAGS + flags
        + ["--distributed", "127.0.0.1:%d,%d,%d" % (port, n, r)],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, DIST_WALL - (time.perf_counter() - t0))))
    except subprocess.TimeoutExpired:
        fail("phase 5g (%s): a rank ran past %d s" % (label, DIST_WALL))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail("phase 5g (%s): rank %d exited %s:\n%s\n%s"
                 % (label, r, p.returncode, out[-3000:], err[-3000:]))
    return [out for out, _ in outs], wall, results, cwd


def xval_differences(got, want):
    """{name: (max |got - want|, max |want|)} over ``XVAL_COMPARED``."""
    import numpy as np

    return {n: (float(np.max(np.abs(got[n] - want[n]))), float(np.max(np.abs(want[n]))))
            for n in XVAL_COMPARED}


def phase_distributed(phase5, want_launches):
    """Phase 5g: ``DIST_LAYOUTS`` of the ``run_xval`` CLI at phase 5's
    configuration (every layout's ranks on 'sample'), ``phase5`` the
    ``Training`` of phase 5 (its step walls and artifacts), ``want_launches``
    its ``dr`` launches, which each rank must repeat.  Returns {label:
    {wall, ranks: {rank: readings}, diffs}} under ``layouts`` and, under
    ``b_differs``, the values where (b) is not phase 5's bit for bit."""
    import statistics

    import numpy as np
    import torch

    spe = phase5.steps_per_epoch
    n_batch, epochs = phase5.n_batch, len(phase5.step_ms) // spe
    n_evals = epochs // int(TRAIN_FLAGS[TRAIN_FLAGS.index("--test_epoch") + 1])
    chunks_train = math.ceil(phase5.dataset_pair.n_train / n_batch)
    chunks_valid = math.ceil(phase5.dataset_pair.n_test / n_batch)
    step5 = statistics.median(phase5.step_ms[spe:])
    print("phase 5g: run_xval over processes on %s (solver %s, B=%d, K=%d, %d epochs, eval every 2 "
          "at K=%d / %d), phase 5's median step %.2f ms"
          % (os.path.basename(SPEC), TRAIN_SOLVER, n_batch, K_TRAIN, epochs, K_TRAIN, K_SERVE,
             step5))
    out = {}
    with tempfile.TemporaryDirectory() as directory:
        spec = write_spec(SPEC, directory, solver=TRAIN_SOLVER)
        for label, n, flags in DIST_LAYOUTS:
            stdouts, wall, results, cwd = launch_ranks(spec, label, n, flags, directory)
            backend = "gloo" if n > torch.cuda.device_count() else "nccl"
            S = n
            readings = {}
            for r, text in enumerate(stdouts):
                first = text.splitlines()[0] if text else ""
                want_first = "torch.distributed: process %d of %d (backend %s, device cuda:0)" % (
                    r, n, backend)
                if first != want_first:
                    fail("phase 5g (%s): rank %d's first line %r, not %r"
                         % (label, r, first, want_first))
                line = [ln for ln in text.splitlines() if ln.startswith(RANK_LINE)]
                if len(line) != 1:
                    fail("phase 5g (%s): rank %d printed no readings" % (label, r))
                readings[r] = got = json.loads(line[0][len(RANK_LINE):])
                R_train = n_batch * math.ceil(K_TRAIN / S)
                R_serve = n_batch * math.ceil(K_SERVE / S)
                want_rows = {"dr_fwd": {str(R_train): len(phase5.step_ms)
                                        + n_evals * chunks_train,
                                        str(R_serve): n_evals * chunks_valid},
                             "dr_bwd": {str(R_train): len(phase5.step_ms)}}
                print("  (%s) rank %d of %d, %s: dr_fwd launches %d, dr_bwd launches %d (phase 5: "
                      "%d / %d); rows a launch %s; median step %.2f ms (phase 5 %.2f ms); "
                      "%g collectives a step, median %.3f ms in them"
                      % (label, r, n, backend, got["launches"]["dr_fwd"],
                         got["launches"]["dr_bwd"], want_launches["dr_fwd"],
                         want_launches["dr_bwd"], json.dumps(got["rows"]), got["step_ms"], step5,
                         got["collectives_per_step"], got["collective_ms_per_step"]))
                if got["launches"] != want_launches or got["rows"] != want_rows:
                    fail("phase 5g (%s): rank %d launched %s at rows %s, not %s at %s"
                         % (label, r, got["launches"], got["rows"], want_launches, want_rows))
                if r > 0 and "Saving results" in text:
                    fail("phase 5g (%s): rank %d wrote the artifacts" % (label, r))
            runs = [d for d in os.listdir(results)]
            if len(runs) != 1 or not os.path.exists(os.path.join(results, runs[0],
                                                                  "completed.txt")):
                fail("phase 5g (%s): experiment directories %s" % (label, runs))
            if os.listdir(cwd):
                fail("phase 5g (%s): a rank wrote %s beside it" % (label, os.listdir(cwd)))
            arrays = xval_arrays(os.path.join(results, runs[0]))
            diffs = xval_differences(arrays, phase5.xval)
            print("  (%s) %.1f s wall; one experiment directory, completed.txt; against phase 5 "
                  "(max |diff|, max |phase 5|): %s"
                  % (label, wall, json.dumps({k: ["%.3e" % d, "%.3e" % m]
                                              for k, (d, m) in diffs.items()})))
            out[label] = dict(wall=wall, ranks=readings, arrays=arrays, diffs=diffs)
    a, b = out["a"]["arrays"], out["b"]["arrays"]
    try:
        np.testing.assert_allclose(a["elbo"], phase5.xval["elbo"], rtol=1e-4)
        for n in ("q_values", "iw_predict_mu"):
            np.testing.assert_allclose(a[n], phase5.xval[n], rtol=2e-3, atol=2e-4)
    except AssertionError as e:
        fail("phase 5g: (a)'s artifacts against phase 5's: %s" % e)
    repeat = bool(np.array_equal(a["elbo"], out["a2"]["arrays"]["elbo"]))
    differ = [n for n in XVAL_COMPARED if not np.array_equal(b[n], phase5.xval[n])]
    exact_a = [n for n in XVAL_COMPARED if np.array_equal(a[n], phase5.xval[n])]
    print("phase 5g: (a) within rtol 1e-4 (xval_elbo) and rtol 2e-3 atol 2e-4 (q_values, "
          "iw_predict_mu) of phase 5, bit-equal in %s; two runs of (a) bit-equal in xval_elbo: "
          "%s; (b) bit-equal to phase 5: %s"
          % (exact_a, repeat, "True" if not differ else "False, differ: %s" % differ))
    if not repeat:
        fail("phase 5g: two runs of (a) differ in xval_elbo")
    for run in out.values():
        del run["arrays"]
    return dict(layouts=out, b_differs=differ, a_bit_equal=exact_a)


def train_nets(device, spec, phase, kind, nets=("precisions",)):
    """Train a model whose kernels carry net weights (a ``_prec`` kind's
    precision nets, the black-box kind's two nets) as ``train`` does; the
    weight cotangent of the kind's backward kernel must move every leaf of
    each of ``nets`` away from its seeded initial value."""
    import torch

    launches, step_ms, training = train(device, spec, phase, kind + "_fwd", kind + "_bwd")
    init = training.model.init_params(torch.Generator().manual_seed(SEED), device=device)
    moved = []
    for net in nets:
        for layer, leaves in init["dec"][net].items():
            for leaf, b in leaves.items():
                a = training.final_params["dec"][net][layer][leaf].detach()
                if not bool(torch.isfinite(a).all()):
                    fail("%s/%s/%s is not finite after training" % (net, layer, leaf))
                moved.append(("%s.%s.%s" % (net, layer, leaf), float((a - b).abs().max())))
    print("  the nets' leaves moved by (max abs change): %s"
          % ", ".join("%s %.3e" % m for m in moved))
    if not all(d > 0 for _, d in moved):
        fail("a net's leaf did not move: the weight cotangent did not reach it")
    return launches, step_ms, training


def one_step(device, solver, rows, K, seed, spec=SPEC, dreg=False, adjoint=False):
    """(Training, params, optimizer, step closure) for one training step of
    ``spec``'s model (dr_constant_icml unless named) under ``solver`` (with
    ``adjoint_solver: true`` where ``adjoint``) on the
    train split's ``rows`` at K draws, with seeded params and draws ``u``,
    set up as run_on_split sets it up; with ``dreg`` the step takes the DReG
    gradient (``training.dreg_value_and_grad``), as ``--dreg`` does.  On
    ``merge: false`` data the rows are those of the first file's group (its
    native 100-point grid)."""
    import numpy as np
    import torch

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.training import (batch_tensors, dreg_value_and_grad, loss_fn,
                                          param_leaves)

    args, settings = training_settings(solver, spec)
    settings.params.adjoint_solver = adjoint
    data, training = run_xval.make_training(args, settings, device=device)
    params, opt, _ = training.init_state(device)
    host = training.train_groups[0][1] if training.multi else data.train.batch()
    batch = batch_tensors(host, np.asarray(rows), torch.as_tensor(
        host.times, dtype=torch.float32, device=device), device)
    u = torch.randn((len(rows), K, training.program.n_theta), device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    mask = torch.ones(len(rows), device=device)

    def step():
        opt.zero_grad()
        if dreg:
            loss, grads = dreg_value_and_grad(training.model, training.program, params, batch,
                                              mask, u)
            for part, part_grads in grads.items():
                for leaf, g in zip(param_leaves(params[part]), part_grads):
                    leaf.grad = g
            return loss
        loss = loss_fn(training.model, training.program, params, batch, mask, u)
        loss.backward()
        return loss

    return training, params, opt, step


def phase_route_check_training(device, spec=SPEC, phase="5b"):
    """One loss and gradient on 4 series x 50 samples, with the same params
    and u, through the kernels (pallas_midpoint) and through the plain
    online log-likelihood route (midpoint) on the card."""
    import torch

    from vihds_tpu_torch.training import param_leaves

    out = {}
    for solver in (TRAIN_SOLVER, "midpoint"):
        _, params, _, step = one_step(device, solver, range(4), 50, SEED + 5, spec)
        loss = step()
        torch.cuda.synchronize()
        grads = [leaf.grad.detach().clone() for leaf in param_leaves(params)]
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[solver] = (float(loss.detach()), grads, sorted(walls)[1])
    (lk, gk, wk), (lf, gf, wf) = out[TRAIN_SOLVER], out["midpoint"]
    rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(gk, gf))
    print("phase %s: one training step of %s, 4 series x 50 samples: loss %s %.4f vs midpoint "
          "fold route %.4f (diff %.3e nats, tol %g); gradients max leaf relative norm diff %.3e "
          "(tol %g); step wall %.4f s (kernels) vs %.4f s (fold route, plain PyTorch)"
          % (phase, os.path.basename(spec)[: -len(".yaml")], TRAIN_SOLVER, lk, lf, abs(lk - lf),
             LOSS_ATOL, rel, GRAD_RTOL, wk, wf))
    if not (abs(lk - lf) <= LOSS_ATOL and rel <= GRAD_RTOL):
        fail("the kernel route's training step disagrees with the fold route")
    return wk, wf


def phase_profile_training(device, spec=SPEC, phase="5c", dreg=False):
    """torch.profiler over one full-size training step (B=36, K=200; with
    ``dreg`` a DReG step) after a warm-up step: device busy share of the
    step's wall and where the model's two fused kernels stand among the
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    training, _, _, step = one_step(device, TRAIN_SOLVER, range(36), K_TRAIN, SEED + 6, spec,
                                    dreg)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events, total_us = device_events(prof)
    if total_us == 0:
        print("phase %s: profiler saw no device time (device busy share: not measured)" % phase)
        return None
    print("phase %s: one %straining step of %s (B=36, K=%d, %s): %d kernel launches, device "
          "busy %.3f ms of %.3f ms unprofiled step wall (busy share %.4f; profiled wall %.3f ms); "
          "top kernels by device time:"
          % (phase, "DReG " if dreg else "", os.path.basename(spec)[: -len(".yaml")], K_TRAIN,
             TRAIN_SOLVER,
             sum(e.count for e in events), total_us / 1e3, wall * 1e3, total_us / 1e6 / wall,
             prof_wall * 1e3))
    for i, e in enumerate(events):
        if i < 10 or "fwd_kernel" in e.key or "bwd_kernel" in e.key:
            print("  #%-3d %9.3f ms  %5d calls  %s"
                  % (i + 1, dev_us(e) / 1e3, e.count, e.key[:100]))
    return dict(busy_ms=total_us / 1e3, wall_ms=wall * 1e3)


XVAL_FLAGS = ["--experiment", "chip_smoke_xval", "--epochs", "2", "--test_epoch", "2",
              "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed", str(SEED),
              "--folds", "4"]


def phase_call_run_xval(device, spec=SPEC, phase="5d"):
    """k-fold cross-validation: ``call_run_xval.execute`` on ``spec``'s model, 4
    folds of 2 epochs each (the depth cut to the smoke's time; evaluation at
    the end of each fold), ``solver: pallas_midpoint``.  It must write each
    fold's best-validation cache, the merged ``xval_*`` set and the completed
    marker, with each series held out by exactly one fold.  Counts the dr
    kernels' launches over the path from 0."""
    import numpy as np

    from vihds_tpu_torch import call_run_xval
    from vihds_tpu_torch.config import Config, Trainer

    args = call_run_xval.create_parser(False).parse_args([spec] + XVAL_FLAGS)
    settings = Config(args)
    settings.params.solver = TRAIN_SOLVER
    name = os.path.basename(spec)[: -len(".yaml")]
    print("phase %s: call_run_xval on %s, %d folds of %d epochs, solver %s, K=%d / %d"
          % (phase, name, args.folds, args.epochs, settings.params.solver, args.train_samples,
             args.test_samples))
    with tempfile.TemporaryDirectory() as results_dir:
        os.environ["INFERENCE_RESULTS_DIR"] = results_dir
        settings.trainer = Trainer(args, add_timestamp=True)
        for k in ("dr_fwd", "dr_bwd"):
            _counter(k).launches = 0
        t0 = time.perf_counter()
        merge = call_run_xval.execute(args, settings, device=device)
        wall = time.perf_counter() - t0
        launches = {k: _counter(k).launches for k in ("dr_fwd", "dr_bwd")}
        names = set(os.listdir(settings.trainer.tb_log_dir))
    del os.environ["INFERENCE_RESULTS_DIR"]
    xval = sorted(n for n in names if n.startswith("xval_"))
    caches = sorted(n for n in names if n.startswith(".vihds_cache_"))
    if merge is None or len(xval) != 16 or "completed.txt" not in names or len(caches) != 4:
        fail("call_run_xval left %s" % sorted(names))
    ids = np.asarray(merge.ids).tolist()
    elbo = np.asarray(merge.elbo, dtype=float)
    if elbo.shape != (args.folds,) or not np.isfinite(elbo).all():
        fail("call_run_xval: fold ELBOs %s" % elbo)
    if len(set(ids)) != len(ids) or sum(int(c) for c in merge.chunk_sizes) != len(ids):
        fail("call_run_xval: a series was held out by more than one fold")
    print("  %d folds in %.1f s wall; fold ELBOs %s; %d xval_* files, caches %s, completed.txt; "
          "%d series held out (per fold %s); dr_fwd launches %d, dr_bwd launches %d"
          % (args.folds, wall, ", ".join("%.1f" % e for e in elbo), len(xval), caches, len(ids),
             [int(c) for c in merge.chunk_sizes], launches["dr_fwd"], launches["dr_bwd"]))
    if min(launches.values()) == 0:
        fail("call_run_xval did not launch the dr kernels: %s" % launches)
    return dict(launches=launches, wall=wall, elbo=elbo.tolist(),
                elbo_list=[list(map(float, e)) for e in merge.elbo_list])


class _RecordedRunner:
    """Keeps the ``xfold.VmapXval`` runners made while it is entered (their
    step times and params are read after the run)."""

    def __enter__(self):
        from vihds_tpu_torch import xfold

        self.made, self._cls = [], xfold.VmapXval
        made = self.made

        class Recorded(self._cls):
            def run(self):
                made.append(self)
                return super().run()

        xfold.VmapXval = Recorded
        return self

    def __exit__(self, *exc):
        from vihds_tpu_torch import xfold

        xfold.VmapXval = self._cls


def vmap_xval(device, spec, flags, phase, kernels, solver=TRAIN_SOLVER):
    """``call_run_xval.execute`` with ``--vmap_folds`` on ``spec``'s model
    under ``solver`` (``pallas_midpoint`` unless named): all folds in one
    batched step.  It must
    train without falling back, write each fold's cache, the 16 merged
    ``xval_*`` files and the completed marker, and hold each series out
    once.  Counts ``kernels``' launches over the path from 0 (each must
    launch).  Returns (readings, the runner)."""
    import statistics

    import numpy as np

    from vihds_tpu_torch import call_run_xval
    from vihds_tpu_torch.config import Config, Trainer

    args = call_run_xval.create_parser(False).parse_args([spec] + flags + ["--vmap_folds"])
    settings = Config(args)
    settings.params.solver = solver
    name = os.path.basename(spec)[: -len(".yaml")]
    print("phase %s: call_run_xval --vmap_folds on %s, %d folds of %d epochs in one batched "
          "step, solver %s, K=%d / %d"
          % (phase, name, args.folds, args.epochs, settings.params.solver, args.train_samples,
             args.test_samples))
    with tempfile.TemporaryDirectory() as results_dir, _RecordedRunner() as rec:
        os.environ["INFERENCE_RESULTS_DIR"] = results_dir
        settings.trainer = Trainer(args, add_timestamp=True)
        for k in kernels:
            _counter(k).launches = 0
        t0 = time.perf_counter()
        merge = call_run_xval.execute(args, settings, device=device)
        wall = time.perf_counter() - t0
        launches = {k: _counter(k).launches for k in kernels}
        names = set(os.listdir(settings.trainer.tb_log_dir))
    del os.environ["INFERENCE_RESULTS_DIR"]
    if len(rec.made) != 1:
        fail("call_run_xval --vmap_folds fell back to the sequential folds")
    runner = rec.made[0]
    xval = sorted(n for n in names if n.startswith("xval_"))
    caches = sorted(n for n in names if n.startswith(".vihds_cache_"))
    if (merge is None or len(xval) != 16 or "completed.txt" not in names
            or caches != [".vihds_cache_%d_of_%d" % (f + 1, args.folds)
                          for f in range(args.folds)]):
        fail("call_run_xval --vmap_folds left %s" % sorted(names))
    ids = np.asarray(merge.ids).tolist()
    elbo = np.asarray(merge.elbo, dtype=float)
    if elbo.shape != (args.folds,) or not np.isfinite(elbo).all():
        fail("call_run_xval --vmap_folds: fold ELBOs %s" % elbo)
    if len(set(ids)) != len(ids) or sum(int(c) for c in merge.chunk_sizes) != len(ids):
        fail("call_run_xval --vmap_folds: a series was held out by more than one fold")
    spe = runner.steps_per_epoch
    step_ms = statistics.median(runner.step_ms[spe:] or runner.step_ms)
    print("  %d folds in %.1f s wall; fold ELBOs %s; %d xval_* files, caches %s, completed.txt; "
          "%d series held out (per fold %s); %d batched steps (%d per epoch), median %.2f ms%s; "
          "%s"
          % (args.folds, wall, ", ".join("%.1f" % e for e in elbo), len(xval), caches, len(ids),
             [int(c) for c in merge.chunk_sizes], len(runner.step_ms), spe, step_ms,
             " after the first epoch" if runner.step_ms[spe:] else "",
             ", ".join("%s launches %d" % kv for kv in launches.items())))
    if launches and min(launches.values()) == 0:
        fail("call_run_xval --vmap_folds did not launch %s" % launches)
    return dict(launches=launches, wall=wall, elbo=elbo.tolist(), step_ms=step_ms,
                elbo_list=[list(map(float, e)) for e in merge.elbo_list]), runner


def batched_step_profile(device, runner, phase):
    """torch.profiler over one batched optimizer step of ``runner``'s folds
    (fresh state, the first batch of epoch 1) after two warm-up steps: the
    device busy time, the launches and the step's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params_v, opt, gen = runner.init_state(device)
    data, n_max = runner._train_data(device)
    idx, mask = runner._chunk_stacks(SEED, 1, 1, [True] * runner.folds, n_max)
    times = torch.as_tensor(runner.train_hosts[0].times, dtype=torch.float32, device=device)

    def step():
        runner.train_steps(params_v, opt, gen, idx[:1], mask[:1], data, times)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events, total_us = device_events(prof)
    if total_us == 0:
        print("phase %s: profiler saw no device time (device busy: not measured)" % phase)
        return dict(busy_ms=None, launches=None, wall_ms=wall * 1e3)
    n = sum(e.count for e in events)
    print("phase %s: one batched step of %d folds (R=%d rows a fold's batch x K=%d): %d kernel "
          "launches, device busy %.3f ms of %.3f ms step wall (busy share %.4f)"
          % (phase, runner.folds, runner.n_batch, runner.args.train_samples, n, total_us / 1e3,
             wall * 1e3, total_us / 1e6 / wall))
    return dict(busy_ms=total_us / 1e3, launches=n, wall_ms=wall * 1e3)


def phase_vmap_xval(device, seq):
    """Phase 5e: phase 5d's 4 folds x 2 epochs of ``dr_constant_icml`` with
    ``--vmap_folds``: the artifacts as 5d checks them, each fold's ELBOs
    against 5d's (rtol ``VMAP_ELBO_RTOL``), the ``dr`` kernels' launches
    against 5d's over 4 (the backward's exactly: one batched step trains
    every fold), the median batched step, one step's device busy time, and
    the wall beside 5d's."""
    import numpy as np

    got, runner = vmap_xval(device, SPEC, XVAL_FLAGS, "5e", ("dr_fwd", "dr_bwd"))
    diff = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))
               for a, b in zip(got["elbo_list"], seq["elbo_list"]))
    quarter = {k: v / VMAP_FOLDS for k, v in seq["launches"].items()}
    print("  fold ELBOs against phase 5d's sequential folds: max relative difference %.3e "
          "(rtol %g); launches %s against 5d's / %d = %s; wall %.1f s against 5d's %.1f s"
          % (diff, VMAP_ELBO_RTOL, got["launches"], VMAP_FOLDS, quarter, got["wall"],
             seq["wall"]))
    if not diff <= VMAP_ELBO_RTOL:
        fail("the batched folds' ELBOs disagree with the sequential folds'")
    if got["launches"]["dr_bwd"] != quarter["dr_bwd"]:
        fail("dr_bwd launched %d times, not 5d's %d / %d"
             % (got["launches"]["dr_bwd"], seq["launches"]["dr_bwd"], VMAP_FOLDS))
    if got["launches"]["dr_fwd"] > quarter["dr_fwd"]:
        fail("dr_fwd launched %d times, more than 5d's / %d" % (got["launches"]["dr_fwd"],
                                                                VMAP_FOLDS))
    got["profile"] = batched_step_profile(device, runner, "5e")
    return got


VMAP_WEIGHTED_FLAGS = ["--experiment", "chip_smoke_vmap", "--epochs", "1", "--test_epoch", "1",
                       "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed",
                       str(SEED), "--folds", str(VMAP_FOLDS)]


def phase_vmap_weighted(device):
    """Phase 5f: one epoch of ``--vmap_folds`` on ``dr_constant_precisions``
    and ``dr_blackbox_icml``: the weighted kernels with their fold axis on
    the training path, with their launches."""
    out = {}
    for spec, kind in ((SPEC_PREC, "dr_prec"), (SPEC_BB, "blackbox")):
        got, _ = vmap_xval(device, spec, VMAP_WEIGHTED_FLAGS, "5f",
                           (kind + "_fwd", kind + "_bwd"))
        out[kind] = got["launches"]
    return out

UNMERGED_FLAGS = ["--experiment", "chip_smoke_unmerged", "--epochs", "2", "--test_epoch", "1",
                  "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed",
                  str(SEED), "--checkpoint_epoch", "1"]


def phase_unmerged_training(device, results_dir):
    """Phase 14: ``dr_constant_icml_unmerged`` (``merge: false``: each file on
    its own grid, five of 100 points and one of 86) trained as phase 5 for 2
    epochs of 8 steps (one file after another, each on its own batches),
    evaluated after each, with a checkpoint after each under
    ``results_dir``.  Returns (launches, the Training that ran)."""
    import numpy as np

    launches, _, training = train(device, SPEC_UNMERGED, "14", "dr_fwd", "dr_bwd",
                                  flags=UNMERGED_FLAGS, results_dir=results_dir)
    groups = [(len(host.times), host.observations.shape[0]) for _, host, _ in
              training.train_groups]
    print("  train groups by file (T, series): %s; step walls %s ms"
          % (groups, ", ".join("%.1f" % t for t in training.step_ms)))
    if training.steps_per_epoch != 8 or sorted({t for t, _ in groups}) != [86, 100]:
        fail("phase 14: %d steps an epoch over groups %s" % (training.steps_per_epoch, groups))
    cache = os.path.join(training.cache_dir, "iw_predict_mu.npy")
    mu = np.load(cache)
    if mu.shape != (training.dataset_pair.n_test, 4, 86) or not np.isfinite(mu).all():
        fail("phase 14: best-validation iw_predict_mu %s" % (mu.shape,))
    return launches, training


def phase_unmerged_kernels(device):
    """Phase 14c: the ``dr`` kernels on the operands one kernel-route training
    step of ``dr_constant_icml_unmerged`` hands them on its first file's
    100-point grid (B=36 x K=200, midpoint): the forward against its plain
    version, the backward on the step's cotangent against the plain version
    in float64, each timed beside its plain version and its bound."""
    import torch

    from vihds_tpu_torch.ops import fused_ode

    kind, wmat, packed, times, traj, g, method = captured_step(device, fused_ode, "kind_bwd",
                                                               SPEC_UNMERGED)
    T, S, R = traj.shape
    if kind != "dr" or T != 100 or method != "midpoint":
        fail("phase 14c: a step launched %s %s at T=%d" % (kind, method, T))
    y0 = traj[0].contiguous()
    with torch.no_grad():
        got = fused_ode.kind_fwd(kind, wmat, packed, y0, times, method)
        ref = fused_ode._plain_fwd(kind, wmat, packed, y0, times, method)
        (rel, _, _), fwd_ok = states_ok(got.movedim(1, -1), ref.movedim(1, -1), kind)
        f = fwd_row(kind, wmat, packed, y0, times, method)
        f["max_abs_err"] = float((got - ref).abs().max())
        dw, dc, dy0 = fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method)
        _, rc, ry0 = fused_ode._plain_bwd(kind, None, packed.double(), times.double(),
                                          traj.double(), g.double(), method)
        got_b, ref_b = torch.cat([dc, dy0]), torch.cat([rc, ry0])
        norm, p99 = cotangent_readings(got_b, ref_b, True)
        bwd_ok = cotangents_ok(got_b, ref_b, True)
        b = timed(lambda: fused_ode.kind_bwd(kind, wmat, packed, times, traj, g, method),
                  lambda: fused_ode._plain_bwd(kind, wmat, packed, times, traj, g, method),
                  4 * (2 * packed.numel() + times.numel() + 2 * T * S * R + S * R),
                  flops_per_step(kind)[1][method] * (T - 1) * R)
        b["max_abs_err"] = float((got_b.double() - ref_b).abs().max())
    print("phase 14c: dr kernels on a training step of dr_constant_icml_unmerged at B=36 K=%d "
          "(R=%d) T=%d, midpoint: dr_fwd max_rel_err %.3e, max_abs_err %.3e  kernel %.4f ms  "
          "plain %.2f ms  bound %.4f ms (%s)  %s; dr_bwd on the step's cotangent (%.4f of it "
          "exactly zero) worst normwise %.3e, worst p99 rel %.3e, max_abs_err %.3e  kernel %.4f "
          "ms  plain %.2f ms  bound %.4f ms (%s)  %s"
          % (K_TRAIN, R, T, rel, f["max_abs_err"], f["ms"], f["plain_ms"], f["bound_ms"],
             f["bound_by"], "ok" if fwd_ok else "MISMATCH", float((g == 0).double().mean()),
             float(norm.max()), float(p99.max()), b["max_abs_err"], b["ms"], b["plain_ms"],
             b["bound_ms"], b["bound_by"], "ok" if bwd_ok else "MISMATCH"))
    if not (fwd_ok and bwd_ok):
        fail("phase 14c: a dr kernel disagrees with its plain version at T=%d" % T)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    return {"fwd": {k: f[k] for k in keys}, "bwd": {k: b[k] for k in keys}, "T": T}


def write_spec(src, directory, files=None, **params):
    """A copy of the spec ``src`` under ``directory`` with ``params`` set in
    its ``params:`` section (the order of its sites kept) and, with
    ``files``, only its first ``files`` CSVs; returns its path."""
    import yaml

    with open(src) as f:
        config = yaml.safe_load(f)
    config["params"].update(params)
    if files is not None:
        config["data"]["files"] = config["data"]["files"][:files]
    path = os.path.join(directory, os.path.basename(src))
    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    return path


def phase_serve_checkpoint(device, training, results_dir):
    """Phase 15: ``predict.main --checkpoint`` on the checkpoints phase 14
    wrote, one request at K=1000 with ``eval_solver: pallas_midpoint`` (the
    spec written with it under ``results_dir``).  The npz must hold finite
    arrays and the newest checkpoint's epoch, the restored params must equal
    the trained ones bit for bit, and ``predict`` on those params in memory,
    from the same generator seed, must give the npz's iw_predict_mu bit for
    bit.  Returns the dr_fwd launches of the request."""
    import numpy as np
    import torch

    from vihds_tpu_torch import predict as P
    from vihds_tpu_torch.training import param_leaves

    spec = write_spec(SPEC_UNMERGED, results_dir, eval_solver=TRAIN_SOLVER)
    out_path = os.path.join(results_dir, "predictions.npz")
    request = ["--data", REQUESTS[0], "--test_samples", str(K_SERVE), "--seed", str(SEED)]
    print("phase 15: serving dr_constant_icml_unmerged from its checkpoint through "
          "predict.main, K=%d, eval_solver=%s" % (K_SERVE, TRAIN_SOLVER))
    _counter("dr_fwd").launches = 0
    t0 = time.perf_counter()
    out = P.main([spec, "--checkpoint", training.ckpt_dir, "--output", out_path] + request,
                 device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counter("dr_fwd").launches
    z = np.load(out_path, allow_pickle=True)
    bad = [k for k in z.files if z[k].dtype.kind == "f" and not np.isfinite(z[k]).all()]
    epoch, restored = P.restore_params(training.ckpt_dir)
    same_params = all(torch.equal(a.cpu(), b.detach().cpu()) for a, b in
                      zip(param_leaves(restored), param_leaves(training.final_params)))
    memory = P.predict(P.create_parser().parse_args([spec] + request), params=restored,
                       device=device)
    same_mu = bool(np.array_equal(memory.merged.iw_predict_mu, z["iw_predict_mu"]))
    B = check_request(out, training.program.n_theta, training.model.ode_model.n_species)
    print("  request %s: %d series on the %d-point encoder grid, wall %.3f s, elbo %.3f, "
          "checkpoint epoch %d; dr_fwd launches %d; restored params bit-equal to the trained: "
          "%s; in-memory predict on them bit-equal in iw_predict_mu: %s"
          % (REQUESTS[0], B, z["times"].shape[0], wall, float(z["elbo"]),
             int(z["checkpoint_epoch"]), launches, same_params, same_mu))
    if bad or int(z["checkpoint_epoch"]) != epoch or epoch != 2:
        fail("phase 15: npz non-finite %s or epoch %s (checkpoint %s)"
             % (bad, z["checkpoint_epoch"], epoch))
    if launches == 0 or not same_params or not same_mu:
        fail("phase 15: launches %d, params equal %s, predictions equal %s"
             % (launches, same_params, same_mu))
    return launches


def phase_zoo(device, results_dir):
    """Phase 16: each of ``ZOO_SPECS`` (models no fused kind covers) trained
    for one epoch through run_on_split at its own solver and widths (B =
    min(n_batch, n_train), K=200; evaluation at K=200 / 1000) with a
    checkpoint, then served one ``predict.main --checkpoint`` request at
    K=1000 on its own CSV.  Returns {spec: (median step ms, request s)}."""
    import statistics

    import numpy as np
    import torch

    from vihds_tpu_torch import predict as P
    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Trainer
    from vihds_tpu_torch.data import procdata

    print("phase 16: the model zoo on the generic solver: 1 epoch at K=%d, then one "
          "predict.main --checkpoint request at K=%d" % (K_TRAIN, K_SERVE))
    walls = {}
    os.environ["INFERENCE_RESULTS_DIR"] = results_dir
    for name in ZOO_SPECS:
        stem = name[: -len(".yaml")]
        spec = os.path.join(HERE, "specs", name)
        if name in ZOO_FIRST_FILE:
            # a spec copy, so that serving reads the grid the model trained on
            spec = write_spec(spec, results_dir, files=1)
        args, settings = training_settings(None, spec, [
            "--experiment", "zoo_" + stem, "--epochs", "1", "--test_epoch", "1",
            "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed", str(SEED),
            "--checkpoint_epoch", "1"])
        settings.trainer = Trainer(args, add_timestamp=True)
        t0 = time.perf_counter()
        data, results, training = run_xval.run_on_split(args, settings, device=device)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        log = training.log_data
        elbos = log.training_elbo_list + log.validation_elbo_list
        if results is None or not elbos or not all(math.isfinite(e) for e in elbos):
            fail("phase 16: %s trained to ELBOs %s" % (stem, elbos))
        # the first of the spec's files with rows of its devices
        csv = next(f for f in settings.data.files if procdata.load(f, settings.data) is not None)
        t0 = time.perf_counter()
        out = P.main([spec, "--checkpoint", training.ckpt_dir, "--data", csv, "--test_samples",
                      str(K_SERVE), "--seed", str(SEED), "--output",
                      os.path.join(results_dir, stem + ".npz")], device=device)
        torch.cuda.synchronize()
        request = time.perf_counter() - t0
        B = check_request(out, training.program.n_theta, iw_state_count(training.model.ode_model))
        if out.epoch != 1:
            fail("phase 16: %s served checkpoint epoch %d" % (stem, out.epoch))
        step_ms = statistics.median(training.step_ms)
        walls[stem] = (step_ms, request)
        print("  %-32s %-27s solver %-8s B=%-2d T=%-3d %d step(s): median %.1f ms; train wall "
              "%.2f s; elbo train %.2f valid %.2f | request %s: %d series, wall %.3f s, elbo "
              "%.3f, mu finite %s"
              % (stem, settings.model, settings.params.solver, training.n_batch,
                 len(data.train.dataset.times), len(training.step_ms), step_ms, train_wall,
                 log.training_elbo_list[-1], log.validation_elbo_list[-1], csv, B, request,
                 out.merged.elbo, bool(np.isfinite(out.merged.iw_predict_mu).all())))
    del os.environ["INFERENCE_RESULTS_DIR"]
    return walls


def phase_growthrate_route(device):
    """Phase 16b: ``dr_growthrate`` under ``solver: pallas_midpoint`` at full
    width (B=36, K=200): its right-hand side has the growth-coupled capacity
    ``es`` that no fused kind computes, so a training step (forward and
    backward) must launch no kernel at all, and its trajectory must equal
    the generic midpoint solver's bit for bit."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox, fused_ode

    counters = {**fused_ode.COUNTERS, **fused_blackbox.COUNTERS}
    training, params, _, step = one_step(device, TRAIN_SOLVER, range(36), K_TRAIN, SEED + 8,
                                         SPEC_GROWTH)
    for c in counters.values():
        c.launches = 0
    loss = float(step().detach())
    ode = training.model.ode_model
    host = training.dataset_pair.train.batch()
    with torch.no_grad():
        th, inputs, dev_1hot, times = _prior_theta(device, training.program, training.model,
                                                   params, host, slice(0, 36), K_TRAIN, SEED + 9)
        routed = ode.simulate(params["dec"], th, times, inputs, dev_1hot, K_TRAIN)
        ode.solver = "midpoint"
        generic = ode.simulate(params["dec"], th, times, inputs, dev_1hot, K_TRAIN)
    torch.cuda.synchronize()
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    same = bool(torch.equal(routed, generic))
    print("phase 16b: dr_growthrate under %s, B=36 K=%d: training step loss %.3f, kernel "
          "launches %s; trajectory %s bit-equal to the generic midpoint solver's: %s"
          % (TRAIN_SOLVER, K_TRAIN, loss, launched or "none", tuple(routed.shape), same))
    if launched or not same or not math.isfinite(loss):
        fail("phase 16b: dr_growthrate launched %s, trajectories equal %s" % (launched, same))


def dreg_pulls(params):
    """The pulls of a DReG step that run a fused backward: the encoder's
    always, and the decoder's where the decoder has leaves (the device
    conditioners of a device-conditioned spec, precision or black-box nets),
    since each of them reaches the ODE."""
    from vihds_tpu_torch.training import param_leaves

    return 1 + bool(param_leaves(params["dec"]))


DREG_FLAGS = ["--experiment", "chip_smoke_dreg", "--epochs", "2", "--test_epoch", "2",
              "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed",
              str(SEED), "--dreg"]


def phase_dreg_training(device, std_step_ms):
    """Phase 17: ``dr_constant_icml`` trained through run_on_split with
    ``--dreg`` under ``solver: pallas_midpoint`` (2 epochs of 7 steps, B=36 x
    K=200, evaluated at the end as phase 5): the step walls beside phase 5's
    (``std_step_ms``), the kernels' launches (``dr_bwd`` once per pull a
    step, ``dr_fwd`` once a step and once per evaluation chunk) and the
    profile of one DReG step."""
    launches, step_ms, training = train(device, SPEC, "17", "dr_fwd", "dr_bwd",
                                        flags=DREG_FLAGS)
    pulls = dreg_pulls(training.final_params)
    print("  DReG: %d backward pulls a step (the decoder's leaves: %s); median step %.2f ms, "
          "phase 5's standard step %.2f ms (%.2fx)"
          % (pulls, ", ".join(sorted(training.final_params["dec"])), step_ms, std_step_ms,
             step_ms / std_step_ms))
    prof = phase_profile_training(device, SPEC, "17", dreg=True)
    return dict(launches=launches, step_ms=step_ms, pulls=pulls,
                busy=prof and prof["busy_ms"], wall=prof and prof["wall_ms"])


#: the specs of phase 17b and the backward kernel each one's kernel route runs
DREG_ROUTE_SPECS = ((SPEC, "dr_bwd"), (SPEC_PREC, "dr_prec_bwd"),
                    (SPEC_RELAY, "relay_prec_bwd"), (SPEC_DEGRADER, "degrader_prec_bwd"),
                    (SPEC_BB, "blackbox_bwd"))


def phase_dreg_route_check(device):
    """Phase 17b: one DReG step on 4 series x 50 samples, with the same
    params and u, through the kernels (pallas_midpoint) and through the
    plain fold route (midpoint), for each spec of ``DREG_ROUTE_SPECS``,
    held to phase 5b's tolerances; the kernel route launches its backward
    once per pull.  Returns {backward kernel: launches in one DReG step}."""
    import torch

    from vihds_tpu_torch.training import param_leaves

    per_step = {}
    for spec, bwd in DREG_ROUTE_SPECS:
        out = {}
        for solver in (TRAIN_SOLVER, "midpoint"):
            _, params, _, step = one_step(device, solver, range(4), 50, SEED + 5, spec, dreg=True)
            _counter(bwd).launches = 0
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = _counter(bwd).launches
            grads = [leaf.grad.detach().clone() for leaf in param_leaves(params)]
            out[solver] = (float(loss), grads, wall, launched, dreg_pulls(params))
        (lk, gk, wk, nk, pulls), (lf, gf, wf, nf, _) = out[TRAIN_SOLVER], out["midpoint"]
        rel = max(float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(gk, gf))
        per_step[bwd] = nk
        print("phase 17b: one DReG step of %s, 4 series x 50 samples: loss %s %.4f vs midpoint "
              "fold route %.4f (diff %.3e nats, tol %g); gradients max leaf relative norm diff "
              "%.3e (tol %g); %s launches %d (pulls reaching the ODE: %d; fold route %d); step "
              "wall %.4f s (kernels) vs %.4f s (fold route)"
              % (os.path.basename(spec)[: -len(".yaml")], TRAIN_SOLVER, lk, lf, abs(lk - lf),
                 LOSS_ATOL, rel, GRAD_RTOL, bwd, nk, pulls, nf, wk, wf))
        if not (abs(lk - lf) <= LOSS_ATOL and rel <= GRAD_RTOL):
            fail("the kernel route's DReG step of %s disagrees with the fold route" % spec)
        if nk != pulls or nf != 0:
            fail("a DReG step of %s launched %s %d times for %d pulls (fold route %d)"
                 % (spec, bwd, nk, pulls, nf))
    return per_step


def captured_pulls(device, module, name, spec):
    """The arguments, detached, of every call to ``module.<name>`` (a
    backward kernel's launch function) in one kernel-route DReG step of
    ``spec``'s model at B=36 x K=200 (``one_step``'s seeded params and
    draws), in the order of the pulls: the decoder's (the standard
    cotangent w-tilde) first, the encoder's (w-tilde^2) last."""
    import torch

    calls = []
    launch = getattr(module, name)

    def capture(*args):
        calls.append([x.detach() if isinstance(x, torch.Tensor) else x for x in args])
        return launch(*args)

    setattr(module, name, capture)
    try:
        _, params, _, step = one_step(device, TRAIN_SOLVER, range(36), K_TRAIN, SEED + 7, spec,
                                      dreg=True)
        step()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, launch)
    if len(calls) != dreg_pulls(params):
        fail("a DReG step of %s called %s %d times for %d pulls"
             % (spec, name, len(calls), dreg_pulls(params)))
    return calls


def phase_dreg_operands(device):
    """Phase 17c: ``dr_bwd``, ``dr_prec_bwd`` and ``blackbox_bwd`` on the
    operands each pull of one DReG step hands them (``captured_pulls``),
    held against the float64 plain sweep at phase 3's limits (elements
    below float32's normal range read normwise only; the black-box sweep on
    the float32 sweep's relu masks), with the cotangent's zero and
    subnormal shares and the kernel's time (median of 20).  Returns {kind:
    {"standard": readings, "dreg": readings}}."""
    import torch

    from vihds_tpu_torch.ops import fused_blackbox as fb, fused_ode

    print("phase 17c: the backward kernels on the operands of one DReG step's pulls (B=36, K=%d, "
          "midpoint), against the plain sweep in float64 within %g normwise and %g at the 99th "
          "percentile of relative error (elements below float32's normal range read normwise "
          "only)" % (K_TRAIN, BWD_NORM_TOL, BWD_P99_TOL))
    out = {}
    for kind, spec in (("dr", SPEC), ("dr_prec", SPEC_PREC), ("blackbox", SPEC_BB)):
        bb = kind == "blackbox"
        calls = (captured_pulls(device, fb, "blackbox_bwd", spec) if bb
                 else captured_pulls(device, fused_ode, "kind_bwd", spec))
        out[kind] = {}
        for label, call in zip(("standard", "dreg")[-len(calls):], calls):
            if bb:
                wflat, packed, times, traj, g, shapes, n_states, method = call

                def run():
                    return fb.blackbox_bwd(wflat, packed, times, traj, g, shapes, n_states,
                                           method)

                dw, dc, dy0 = run()
                _, ref, _, _ = bb_references(fb._split(wflat, shapes), packed, times, traj, g,
                                             n_states, method)
                norm, rel, ok = bb_cotangent_readings(dw, dc, dy0, ref, shapes, True)
            else:
                got_kind, wmat, packed, times, traj, g, method = call
                k = fused_ode.KINDS[got_kind]

                def run():
                    return fused_ode.kind_bwd(got_kind, wmat, packed, times, traj, g, method)

                dw, dc, dy0 = run()
                ref_w, ref_c, ref_y = fused_ode._plain_bwd(
                    got_kind, wmat.double() if k.prec else None, packed.double(),
                    times.double(), traj.double(), g.double(), method)
                got, ref = [torch.cat([dc, dy0])], [torch.cat([ref_c, ref_y])]
                if k.prec:
                    got.append(dw)
                    ref.append(ref_w)
                norm, rel = (torch.cat(x) for x in zip(*(cotangent_readings(a, b, True)
                                                         for a, b in zip(got, ref))))
                ok = all(cotangents_ok(a, b, True) for a, b in zip(got, ref))
            torch.cuda.synchronize()
            r = out[kind][label] = dict(
                zero_share=float((g == 0).double().mean()),
                subnormal_share=float(((g != 0) & (g.abs() < FLT_MIN)).double().mean()),
                worst_norm=float(norm.max()), worst_p99=float(rel.max()),
                ms=cuda_ms(run, 20))
            print("  %-16s %s pull (cotangent %s): %.4f exactly zero, %.4f subnormal; worst "
                  "normwise %.3e, worst p99 rel %.3e; kernel %.4f ms  %s"
                  % ("blackbox_bwd" if bb else fused_ode.KINDS[call[0]].bwd, label,
                     "w-tilde^2" if label == "dreg" else "w-tilde", r["zero_share"],
                     r["subnormal_share"], r["worst_norm"], r["worst_p99"], r["ms"],
                     "ok" if ok else "MISMATCH"))
            if not ok:
                fail("%s disagrees with its plain version on the %s pull's operands of a DReG "
                     "step" % (kind, label))
    return out


PROFILE_FLAGS = ["--experiment", "chip_smoke_profile", "--epochs", "2", "--test_epoch", "1",
                 "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed",
                 str(SEED), "--plot_epoch", "0"]


def phase_profile_dir(device):
    """Phase 18: ``dr_constant_icml`` through run_on_split with
    ``--profile_dir`` (2 epochs, ``solver: pallas_midpoint``): exactly one
    trace, of epoch 2 (the first chunk after the start epoch), written as a
    Chrome trace, whose kernel events (``device_events``) name the fused
    forward and backward."""
    import json as json_

    from vihds_tpu_torch import profiling, run_xval
    from vihds_tpu_torch.config import Trainer

    with tempfile.TemporaryDirectory() as results_dir:
        profile_dir = os.path.join(results_dir, "profile")
        args, settings = training_settings(flags=PROFILE_FLAGS + ["--profile_dir", profile_dir])
        os.environ["INFERENCE_RESULTS_DIR"] = results_dir
        settings.trainer = Trainer(args, add_timestamp=True)
        profs = []
        trace = profiling.trace

        @contextlib.contextmanager
        def kept(directory, name="trace"):
            with trace(directory, name) as prof:
                yield prof
            if prof is not None:
                profs.append(prof)

        profiling.trace = kept
        try:
            t0 = time.perf_counter()
            run_xval.run_on_split(args, settings, device=device)
            wall = time.perf_counter() - t0
        finally:
            profiling.trace = trace
            del os.environ["INFERENCE_RESULTS_DIR"]
        names = sorted(os.listdir(profile_dir))
        size = sum(os.path.getsize(os.path.join(profile_dir, n)) for n in names)
        with open(os.path.join(profile_dir, names[0])) as f:
            kernel_names = {e.get("name", "") for e in json_.load(f)["traceEvents"]
                            if e.get("cat") == "kernel"}
    if names != ["epochs_2-2.json"] or len(profs) != 1:
        fail("phase 18: --profile_dir wrote %s (%d traces)" % (names, len(profs)))
    events, total_us = device_events(profs[0])
    fused = [e.key for e in events if "fwd_kernel" in e.key or "bwd_kernel" in e.key]
    in_file = [n for n in kernel_names if "fwd_kernel" in n or "bwd_kernel" in n]
    print("phase 18: run_on_split with --profile_dir, 2 epochs of 7 steps in %.1f s: %s (%d "
          "bytes), %d kernel launches, device busy %.3f ms in the traced epoch; the fused "
          "kernels in it: %s; in the Chrome trace's kernel events: %d of them"
          % (wall, names, size, sum(e.count for e in events), total_us / 1e3,
             "; ".join("%s (%d calls)" % (e.key[:60], e.count) for e in events
                       if e.key in fused), len(in_file)))
    if not (any("fwd_kernel" in k for k in fused) and any("bwd_kernel" in k for k in fused)
            and in_file):
        fail("phase 18: the trace does not name the fused forward and backward: %s" % fused)
    return dict(bytes=size, busy_ms=total_us / 1e3)


FIGURE_FLAGS = ["--experiment", "chip_smoke_figures", "--epochs", "2", "--test_epoch", "1",
                "--plot_epoch", "2", "--train_samples", str(K_TRAIN), "--test_samples",
                str(K_SERVE), "--seed", str(SEED)]


def phase_figures(device, keep=None):
    """Phase 18b: ``run_xval.main`` on ``dr_constant_icml`` (its spec with
    ``solver: pallas_midpoint``) for 2 epochs with ``--plot_epoch 2``.  Where
    matplotlib, seaborn and tensorboard import, ``--figures``: the split's
    event files with their scalars and figures, and the xval figures.  Where
    one does not, the run says once which and still writes its ``xval_*``
    set, and ``--figures`` stops before any training, naming the package.
    ``keep``: where the run's directory is copied (phase 20n reads it)."""
    import contextlib as contextlib_
    import io

    from vihds_tpu_torch import run_xval, utils

    missing = utils.missing_packages(utils.FIGURE_PACKAGES)
    with tempfile.TemporaryDirectory() as results_dir:
        spec = write_spec(SPEC, results_dir, solver=TRAIN_SOLVER)
        os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(results_dir, "results")
        # each of the lines is said once a process: let this run say it again
        utils._NOTED.clear()
        argv = [spec] + FIGURE_FLAGS + ([] if missing else ["--figures"])
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib_.redirect_stdout(buf):
                run_xval.main(argv, device=device)
        finally:
            del os.environ["INFERENCE_RESULTS_DIR"]
        wall = time.perf_counter() - t0
        (run_dir,) = os.listdir(os.path.join(results_dir, "results"))
        run_dir = os.path.join(results_dir, "results", run_dir)
        if keep:
            shutil.copytree(run_dir, keep)
        names = sorted(os.listdir(run_dir))
        xval = [n for n in names if n.startswith("xval_") and n.endswith((".npy", ".txt"))]
        figures = [n for n in names if n.endswith((".png", ".pdf"))]
        events = {d: sorted(os.listdir(os.path.join(run_dir, d)))
                  for d in ("train_1_of_4", "valid_1_of_4", "xval") if d in names}
        stopped = None
        if missing:
            os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(results_dir, "figures")
            try:
                run_xval.main(argv + ["--figures"], device=device)
            except SystemExit as e:
                stopped = str(e)
            finally:
                del os.environ["INFERENCE_RESULTS_DIR"]
            trained = os.path.exists(os.path.join(results_dir, "figures"))
    said = [line for line in buf.getvalue().splitlines() if line.endswith("is not installed")]
    print("phase 18b: run_xval.main, 2 epochs, --plot_epoch 2%s, in %.1f s: the figures' "
          "packages missing: %s; %d xval_* files, %d figure files, event files %s; said: %s"
          % ("" if missing else " --figures", wall, missing or "none", len(xval), len(figures),
             events, said))
    if len(xval) != 16:
        fail("phase 18b: the run wrote %d xval_* files" % len(xval))
    if missing:
        want = "--figures needs the %s package, which is not installed" % missing[0]
        print("phase 18b: --figures without %s: %r; a results directory made: %s"
              % (missing[0], stopped, trained))
        tensorboard = "tensorboard" not in missing
        if (stopped != want or trained or not said
                or bool(events.get("train_1_of_4")) != tensorboard):
            fail("phase 18b: without %s the run said %s, --figures %r (results made: %s)"
                 % (missing, said, stopped, trained))
    elif not (figures and events.get("xval") and events.get("train_1_of_4")
              and events.get("valid_1_of_4")):
        fail("phase 18b: --figures wrote %s" % names)
    return dict(missing=missing, figures=len(figures))



ADAPTIVE_SOLVER = "dopri5"
ADAPTIVE_FLAGS = ["--experiment", "chip_smoke_dopri5", "--epochs", "1", "--test_epoch", "1",
                  "--train_samples", str(K_TRAIN), "--test_samples", str(K_SERVE), "--seed",
                  str(SEED)]
#: phase 19's data: the spec's first CSV (72 training series, 2 steps an
#: epoch at B = 36 x K = 200, 24 validation series).  Its depth was cut from
#: all six (7 steps an epoch) to keep the script within its time limit when
#: the recovery study's HMC stages came (each dopri5 step takes seconds)
ADAPTIVE_FILES = 1


class CountingRhs:
    """A right-hand side that records the time of each of its calls (one
    device sync a call: this counting run is not timed)."""

    def __init__(self, rhs):
        self.rhs, self.ts = rhs, []

    def __call__(self, t, y):
        self.ts.append(float(t))
        return self.rhs(t, y)


def adaptive_step_counts(ts, times, stages, cap):
    """Per interval of the grid ``times``: (attempted, accepted) steps of
    one adaptive forward whose right-hand side was called at ``ts`` (each
    step calls it ``stages`` times, the first at the step's start).  A step
    is accepted where the next step of its interval starts later, or where
    it ends its interval below the cap; the last step of an interval that
    hit the cap counts as rejected."""
    import numpy as np

    starts = np.asarray(ts[::stages])
    interval = np.searchsorted(np.asarray(times), starts, side="right") - 1
    attempted = np.bincount(interval, minlength=len(times) - 1)
    accepted = np.zeros_like(attempted)
    for j, i in enumerate(interval):
        last = j + 1 == len(starts) or interval[j + 1] != i
        accepted[i] += (starts[j + 1] > starts[j]) if not last else attempted[i] < cap
    return attempted, accepted


def phase_adaptive(device):
    """Phase 19: path (a), ``dr_constant_icml`` under ``solver: dopri5``
    (the continuous adjoint's backward, no kernel): ``run_on_split`` on the
    spec's first CSV (``ADAPTIVE_FILES``) for one epoch of 2 steps at B=36 x
    K=200, evaluated at K=200 (train split) and K=1000 (valid split), the
    xval artifacts; the steps one forward takes
    per interval on a training step's operands (``dopri.integrate_adaptive``
    on the model's own right-hand side, its calls counted); one ``predict``
    request at K=1000 on the trained params; and one epoch with ``--dreg``."""
    import statistics

    import numpy as np
    import torch

    from vihds_tpu_torch import run_xval
    from vihds_tpu_torch.config import Trainer
    from vihds_tpu_torch.ops import dopri
    from vihds_tpu_torch.predict import create_parser, predict
    from vihds_tpu_torch.training import batch_tensors

    out = {}
    for dreg in (False, True):
        args, settings = training_settings(ADAPTIVE_SOLVER, SPEC,
                                           ADAPTIVE_FLAGS + (["--dreg"] if dreg else []))
        settings.data.files = settings.data.files[:ADAPTIVE_FILES]
        with tempfile.TemporaryDirectory() as results_dir:
            os.environ["INFERENCE_RESULTS_DIR"] = results_dir
            settings.trainer = Trainer(args, add_timestamp=True)
            t0 = time.perf_counter()
            data, results, training = run_xval.run_on_split(args, settings, device=device)
            wall = time.perf_counter() - t0
            if results is None:
                fail("phase 19: training left no best-validation results")
            run_xval.save_xval(args, settings, data, results)
            names = os.listdir(settings.trainer.tb_log_dir)
        del os.environ["INFERENCE_RESULTS_DIR"]
        log = training.log_data
        elbos = log.training_elbo_list + log.validation_elbo_list + list(results.elbo_list)
        n_xval = len([n for n in names if n.startswith("xval_")])
        if not elbos or not all(math.isfinite(e) for e in elbos) or n_xval != 16:
            fail("phase 19: ELBOs %s, %d xval_* files" % (elbos, n_xval))
        step_ms = statistics.median(training.step_ms)
        print("phase 19: %s, split 1 of 4, solver %s%s, B=%d, K=%d, %d epoch(s) of %d steps in "
              "%.2f s wall (evaluation at K=%d / %d included); median step %.1f ms (steps: %s "
              "ms); ELBOs %s; %d xval_* files"
              % ("dr_constant_icml", settings.params.solver, " --dreg" if dreg else "",
                 settings.params.n_batch, args.train_samples, args.epochs,
                 training.steps_per_epoch, wall, args.train_samples, args.test_samples, step_ms,
                 ", ".join("%.0f" % t for t in training.step_ms),
                 ", ".join("%.1f" % e for e in elbos), n_xval))
        out["dreg_step_ms" if dreg else "step_ms"] = step_ms
        out["dreg_wall" if dreg else "wall"] = wall
        if dreg:
            continue

        # the steps of one forward, on the operands of a training step
        model, program, params = training.model, training.program, training.final_params
        host = data.train.batch()
        B = settings.params.n_batch
        times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
        batch = batch_tensors(host, np.arange(B), times, device)
        gen = torch.Generator(device=device).manual_seed(SEED + 7)
        with torch.no_grad():
            q = model.encoder(params["enc"], batch)
            u = model.sample_u(gen, B, K_TRAIN, device)
            th = program.theta_dict(program.clip(program.sample(q, u)))
            ode = model.ode_model
            th = ode.condition_theta(params["dec"], th, batch.dev_1hot)
            y0 = ode.initialize_state(params["dec"], th, batch.inputs, B, K_TRAIN)
            rhs = CountingRhs(ode.make_rhs(params["dec"], th, batch.inputs, batch.dev_1hot))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dopri.integrate_adaptive(rhs, y0, times, method=ADAPTIVE_SOLVER)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        cap = dopri.max_steps_default(ADAPTIVE_SOLVER)
        attempted, accepted = adaptive_step_counts(rhs.ts, host.times, 7, cap)
        rejected = attempted - accepted
        out.update(steps_total=int(attempted.sum()), steps_max=int(attempted.max()),
                   accepted_total=int(accepted.sum()), rejected_total=int(rejected.sum()),
                   rejected_max=int(rejected.max()), capped=int((attempted >= cap).sum()),
                   rhs_calls=len(rhs.ts), counted_forward_s=fwd_s)
        print("phase 19: one dopri5 forward on a training step's operands (B=%d x K=%d, T=%d): "
              "%d steps attempted (%d accepted, %d rejected) over %d intervals, per interval "
              "max %d (max rejected %d); %d right-hand side calls; intervals at the cap of %d: "
              "%d; %.3f s with a sync per call"
              % (B, K_TRAIN, len(host.times), out["steps_total"], out["accepted_total"],
                 out["rejected_total"], len(attempted), out["steps_max"], out["rejected_max"],
                 len(rhs.ts), cap, out["capped"], fwd_s))
        if out["capped"]:
            fail("phase 19: %d interval(s) hit the step cap" % out["capped"])
        out["folds"] = phase_adaptive_folds(device, model, program, params, host)

        # one serving request at K=1000 on the trained params
        req = create_parser().parse_args([SPEC, "--data", REQUESTS[0], "--test_samples",
                                          str(K_SERVE), "--seed", str(SEED)])
        t0 = time.perf_counter()
        served = predict(req, settings, params=params, device=device)
        torch.cuda.synchronize()
        out["request_s"] = time.perf_counter() - t0
        n = check_request(served, program.n_theta, iw_state_count(ode))
        print("phase 19: a predict request under %s, %s, %d series at K=%d: wall %.3f s, "
              "elbo %.3f" % (model.ode_model._solver_for(True), REQUESTS[0],
                             n, K_SERVE, out["request_s"], served.merged.elbo))
    return out


#: phase 19c: the folds of the fold-stacked forward; fold f takes the f % 2
#: batch of phase 19's 72 training series and a draw u of its own
ADAPTIVE_FOLDS = 4
#: phase 19c: each fold's trajectory against the fold alone
FOLD_RTOL, FOLD_ATOL = 1e-4, 1e-6


def phase_adaptive_folds(device, model, program, params, host):
    """Phase 19c: ``dopri.integrate_adaptive(folds=4)`` (a step controller
    per fold) on 4 folds' training-step operands of phase 19's trained
    model, each B=36 x K=200 (R = 28,800 rows: fold f the f % 2 batch of
    the training split and a draw u of its own), against each fold
    integrated alone: each fold's attempted and accepted steps per interval
    equal, its trajectory within ``FOLD_RTOL`` / ``FOLD_ATOL`` (and whether
    bit-equal), the walls."""
    import numpy as np
    import torch

    from vihds_tpu_torch.ops import dopri
    from vihds_tpu_torch.training import batch_tensors

    B, F = 36, ADAPTIVE_FOLDS
    n_train = host.observations.shape[0]
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    ode = model.ode_model
    folds = []
    with torch.no_grad():
        for f in range(F):
            batch = batch_tensors(host, (np.arange(B) + (f % 2) * B) % n_train, times, device)
            gen = torch.Generator(device=device).manual_seed(SEED + 11 + f)
            q = model.encoder(params["enc"], batch)
            u = model.sample_u(gen, B, K_TRAIN, device)
            th = program.theta_dict(program.clip(program.sample(q, u)))
            th = ode.condition_theta(params["dec"], th, batch.dev_1hot)
            folds.append((th, batch, ode.initialize_state(params["dec"], th, batch.inputs, B,
                                                          K_TRAIN)))
        th_all = {k: torch.cat([th[k] for th, _, _ in folds]) for k in folds[0][0]}
        rhs = ode.make_rhs(params["dec"], th_all,
                           torch.cat([b.inputs for _, b, _ in folds]),
                           torch.cat([b.dev_1hot for _, b, _ in folds]))
        y0 = torch.cat([y for _, _, y in folds])
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = dopri.integrate_adaptive(rhs, y0, times, method=ADAPTIVE_SOLVER, folds=F,
                                      stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        alone_walls, same_steps, close, exact = [], [], [], []
        for f, (th, batch, y0_f) in enumerate(folds):
            alone = {}
            t0 = time.perf_counter()
            y = dopri.integrate_adaptive(ode.make_rhs(params["dec"], th, batch.inputs,
                                                      batch.dev_1hot), y0_f, times,
                                         method=ADAPTIVE_SOLVER, stats=alone)
            torch.cuda.synchronize()
            alone_walls.append(time.perf_counter() - t0)
            got = ys[:, f * B:(f + 1) * B]
            same_steps.append(bool(torch.equal(stats["attempted"][:, f], alone["attempted"])
                                   and torch.equal(stats["accepted"][:, f], alone["accepted"])))
            close.append(bool(torch.allclose(got, y, rtol=FOLD_RTOL, atol=FOLD_ATOL)))
            exact.append(bool(torch.equal(got, y)))
    attempted = stats["attempted"]
    out = dict(wall=wall, alone_walls=alone_walls, attempted=attempted.sum(0).tolist(),
               accepted=stats["accepted"].sum(0).tolist(),
               per_interval_max=attempted.max(0).values.tolist(), steps_equal=same_steps,
               close=close, bit_equal=exact)
    print("phase 19c: the fold-stacked %s forward on %d folds' training-step operands (B=%d x "
          "K=%d each, R = %d, T=%d): %.3f s wall; each fold alone %s s (sum %.3f); per fold "
          "attempted steps %s (accepted %s), per interval max %s; per interval equal to the "
          "fold alone: %s; trajectories within rtol %g atol %g: %s, bit-equal: %s"
          % (ADAPTIVE_SOLVER, F, B, K_TRAIN, F * B * K_TRAIN, len(host.times), wall,
             ", ".join("%.3f" % w for w in alone_walls), sum(alone_walls), out["attempted"],
             out["accepted"], out["per_interval_max"], same_steps, FOLD_RTOL, FOLD_ATOL, close,
             exact))
    if not all(same_steps) or not all(close):
        fail("phase 19c: a fold's steps or trajectory differ from the fold alone")
    return out


#: phase 19d: phase 19's configuration (the spec's first CSV, solver
#: dopri5) over 4 folds in one batched step, one epoch, K = 200 in both
#: evaluations (the valid split's 1000 cut to keep the script's time)
VMAP_ADAPTIVE_FLAGS = ["--experiment", "chip_smoke_dopri5_vmap", "--epochs", "1",
                       "--test_epoch", "1", "--train_samples", str(K_TRAIN), "--test_samples",
                       str(K_TRAIN), "--seed", str(SEED), "--folds", str(ADAPTIVE_FOLDS)]
#: phase 19d: a fold's first batched loss against the fold's own step
VMAP_LOSS_RTOL = 1e-5


def phase_vmap_adaptive(device):
    """Phase 19d: ``call_run_xval --vmap_folds`` on phase 19's configuration
    (``dr_constant_icml`` under ``solver: dopri5``, its first CSV), 4 folds
    x 1 epoch at K=200: the artifacts as 5e checks them; the first batched
    step's per-fold loss against a one-fold step of each fold on the same
    params, rows, mask and u (``VMAP_LOSS_RTOL``, and whether bit-equal)."""
    import torch

    from vihds_tpu_torch import xfold
    from vihds_tpu_torch.training import loss_fn
    from vihds_tpu_torch.utils.attrdict import AttrDict

    first = []
    batched_loss = xfold.loss_fn

    def recorded(model, program, params, batch, mask, u, folds=None):
        loss = batched_loss(model, program, params, batch, mask, u, folds=folds)
        if not first:
            first.append(dict(params=_map_tree(lambda v: v.detach().clone(), params),
                              batch=AttrDict(batch), mask=mask, u=u, loss=loss.detach().clone(),
                              folds=folds))
        return loss

    xfold.loss_fn = recorded
    try:
        with tempfile.TemporaryDirectory() as spec_dir:
            got, runner = vmap_xval(device, write_spec(SPEC, spec_dir, files=ADAPTIVE_FILES),
                                    VMAP_ADAPTIVE_FLAGS, "19d", (), solver=ADAPTIVE_SOLVER)
    finally:
        xfold.loss_fn = batched_loss
    step = first[0]
    F, B = step["folds"], runner.n_batch
    alone, rel, exact = [], [], []
    with torch.no_grad():
        for f in range(F):
            rows = slice(f * B, (f + 1) * B)
            batch = AttrDict((k, v if k == "times" else v[rows]) for k, v in step["batch"].items())
            loss = loss_fn(runner.model, runner.program,
                           _map_tree(lambda v: v[f], step["params"]), batch, step["mask"][rows],
                           step["u"][rows])
            alone.append(float(loss))
            want = float(step["loss"][f])
            rel.append(abs(alone[-1] - want) / abs(want))
            exact.append(bool(torch.equal(loss, step["loss"][f])))
    got.update(first_losses=step["loss"].tolist(), alone_losses=alone, rel=rel, bit_equal=exact)
    print("phase 19d: the first batched step's fold losses %s against each fold's own step %s: "
          "max relative difference %.3e (rtol %g), bit-equal %s"
          % (", ".join("%.4f" % v for v in got["first_losses"]),
             ", ".join("%.4f" % v for v in alone), max(rel), VMAP_LOSS_RTOL, exact))
    if not max(rel) <= VMAP_LOSS_RTOL:
        fail("phase 19d: a fold's batched loss differs from its own step's")
    return got


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def phase_adjoint_check(device):
    """Phase 19b: one training step on 4 series x 50 samples, with the same
    params and u: the dopri5 adjoint's gradient against the fold route's rk4
    gradient, and ``adjoint_solver: true`` midpoint against the fold route's
    midpoint, each leaf within ADJOINT_RTOL of its largest entry."""
    import torch

    from vihds_tpu_torch.training import param_leaves

    out = {}
    for solver, adjoint, ref in ((ADAPTIVE_SOLVER, False, "rk4"), ("midpoint", True, "midpoint")):
        res = {}
        for name, s, adj in (("adjoint", solver, adjoint), ("fold", ref, False)):
            _, params, _, step = one_step(device, s, range(4), 50, SEED + 5, adjoint=adj)
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            res[name] = (float(loss.detach()), time.perf_counter() - t0,
                         [leaf.grad.detach().clone() for leaf in param_leaves(params)])
        (la, wa, ga), (lf, wf, gf) = res["adjoint"], res["fold"]
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(ga, gf))
        label = "%s%s" % (solver, " adjoint_solver" if adjoint else "")
        print("phase 19b: one training step of dr_constant_icml, 4 series x 50 samples: %s "
              "loss %.4f vs fold route %s %.4f; gradients max leaf |diff| / leaf max %.3e "
              "(tol %g); step wall %.3f s (adjoint) vs %.3f s (fold route)"
              % (label, la, ref, lf, worst, ADJOINT_RTOL, wa, wf))
        if not worst <= ADJOINT_RTOL:
            fail("phase 19b: the %s adjoint's gradient disagrees with the fold route's %s"
                 % (label, ref))
        out[label] = dict(worst=worst, wall=wa, fold_wall=wf)
    return out


def graph_doc(directory, spec_dr):
    """The demo graph with ``epochs`` / ``test_epoch`` cut to 2 and ``folds:
    2`` on each node, its specs as absolute paths and the ``dr`` node's
    spec replaced by ``spec_dr``; returns the YAML's path."""
    import yaml

    with open(os.path.join(HERE, "inferencegraphs", "demo_graph.yaml")) as f:
        doc = yaml.safe_load(f)
    for name, node in doc["nodes"].items():
        node.update(epochs=2, test_epoch=2, folds=2)
        node["spec"] = spec_dr if name == "dr" else os.path.join(HERE, node["spec"])
    path = os.path.join(directory, "demo_graph.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return path


def check_propagation(result, graph_path):
    """Each downstream node's propagatedParams.txt against mu and sigma
    recomputed from its upstream's xval_q_* files; returns (propagated,
    skipped) edge counts."""
    import numpy as np

    from vihds_tpu_torch import inference_graph as ig

    graph = ig.create_inference_graph(graph_path, "check")
    propagated = skipped = 0
    for name, node in graph.items():
        if not node.incoming:
            continue
        with open(os.path.join(result[name], "propagatedParams.txt")) as f:
            prop = f.read()
        for edge in node.incoming:
            up = result[edge.source.name]
            values = np.load(os.path.join(up, "xval_q_values.npy"), allow_pickle=True)
            with open(os.path.join(up, "xval_q_names.txt")) as f:
                names = [line.rstrip() for line in f]
            if edge.sourceParam + ".mu" not in names:
                skipped += 1
                continue
            mu = float(np.mean(values[names.index(edge.sourceParam + ".mu")]))
            precs = values[names.index(edge.sourceParam + ".prec")]
            sigma = 1.0 / np.sqrt(float(len(precs) / sum(1.0 / x for x in precs)))
            want = "%r: AttrDict({'distribution': 'LogNormal', 'mu': %r, 'sigma': %r})" % (
                edge.targetParam, mu, sigma)
            if want not in prop:
                fail("phase 20: %s's propagatedParams.txt lacks %s" % (name, want))
            propagated += 1
    return propagated, skipped


def phase_graph(device):
    """Phase 20: path (c), the demo inference graph (auto -> prpr -> dr, the
    ``*_constant_precisions`` models at the graph's own K=50 / 100) with
    epochs cut to 2 and 2 folds a node, its ``dr`` node under ``solver:
    pallas_midpoint`` (the ``dr_prec`` kernels, launches counted): each
    downstream prior held against its upstream's files, then a second run
    that skips all three nodes and launches nothing."""
    import io

    from vihds_tpu_torch import run_inference_graph as rig

    with tempfile.TemporaryDirectory() as directory:
        os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(directory, "results")
        spec_dr = write_spec(SPEC_PREC, directory, solver=TRAIN_SOLVER)
        path = graph_doc(directory, spec_dr)
        runs = []
        for _ in range(2):
            for k in ("dr_prec_fwd", "dr_prec_bwd"):
                _counter(k).launches = 0
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                result = rig.main([path, "--graph", "demo"], device=device)
            wall = time.perf_counter() - t0
            launches = {k: _counter(k).launches for k in ("dr_prec_fwd", "dr_prec_bwd")}
            marks = {n: os.path.getmtime(os.path.join(d, "completed.txt"))
                     for n, d in result.items()}
            runs.append((result, wall, launches, text.getvalue(), marks))
        propagated, skipped = check_propagation(runs[0][0], path)
    del os.environ["INFERENCE_RESULTS_DIR"]
    (result, wall, launches, log, marks), (again, wall2, launches2, log2, marks2) = runs
    warnings = [line for line in log.splitlines() if line.startswith("WARNING")]
    targets = [line for line in log.splitlines() if line.startswith("Target parameter")]
    print("phase 20: the demo graph, 3 nodes x 2 folds x 2 epochs, dr under %s: %.1f s wall; "
          "nodes %s; %d edges propagated (each prior equal to mu, 1/sqrt(pooled prec) "
          "recomputed from its upstream's files), %d skipped (%s); dr_prec_fwd launches %d, "
          "dr_prec_bwd launches %d"
          % (TRAIN_SOLVER, wall, sorted(n for n in result), propagated, skipped,
             "; ".join(warnings) or "none", launches["dr_prec_fwd"], launches["dr_prec_bwd"]))
    for line in targets:
        print("  " + line)
    skipped_nodes = sorted(n for n in result if "Node %s already completed." % n in log2)
    print("phase 20: second run in %.1f s: skipped %s; launches %s; completed.txt untouched: %s"
          % (wall2, skipped_nodes, launches2, marks2 == marks))
    if sorted(result) != ["auto", "dr", "prpr"] or not propagated:
        fail("phase 20: nodes %s, %d edges propagated" % (sorted(result), propagated))
    if min(launches.values()) == 0:
        fail("phase 20: the dr node did not launch the dr_prec kernels: %s" % launches)
    if again != result or skipped_nodes != sorted(result) or any(launches2.values()) or \
            marks2 != marks:
        fail("phase 20: the second run did not skip every node")
    return dict(wall=wall, launches=launches, propagated=propagated, skipped=skipped)


def phase_graph_jobs(device):
    """Phase 20b: ``--jobs 2`` on two same-stage ``dr_constant_icml`` nodes
    (the kernel route, 1 epoch, 2 folds, K=200 / 1000) in spawn workers on
    the one card: both complete."""
    import yaml

    from vihds_tpu_torch import run_inference_graph as rig

    with tempfile.TemporaryDirectory() as directory:
        os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(directory, "results")
        spec = write_spec(SPEC, directory, solver=TRAIN_SOLVER)
        node = dict(spec=spec, seed=0, epochs=1, test_epoch=1, plot_epoch=0, folds=2,
                    train_samples=K_TRAIN, test_samples=K_SERVE)
        doc = {"nodes": {"left": dict(node, experiment="left"),
                         "right": dict(node, experiment="right", seed=1)}, "edges": []}
        path = os.path.join(directory, "jobs.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(doc, f)
        t0 = time.perf_counter()
        result = rig.main([path, "--graph", "jobs", "--jobs", "2"], device=device)
        wall = time.perf_counter() - t0
        done = {n: open(os.path.join(d, "completed.txt")).read() for n, d in result.items()}
        n_xval = {n: len([x for x in os.listdir(d) if x.startswith("xval_")
                          and x.endswith((".npy", ".txt"))]) for n, d in result.items()}
    del os.environ["INFERENCE_RESULTS_DIR"]
    print("phase 20b: --jobs 2, two dr_constant_icml nodes (%s, 1 epoch, 2 folds) in spawn "
          "workers: %.1f s wall; completed %s; xval_* files %s"
          % (TRAIN_SOLVER, wall, done, n_xval))
    if done != {"left": "jobs/left", "right": "jobs/right"} or set(n_xval.values()) != {16}:
        fail("phase 20b: the workers left %s, %s" % (done, n_xval))
    return dict(wall=wall)


SPEC_ONE = os.path.join(HERE, "specs", "dr_constant_one.yaml")
#: the recovery study's simulator flags (tools/recovery_study.py's defaults:
#: 48 series a device, the recorded study's design) but ``--max_scaled``
CALIBRATE_TARGET = 1.0
SIM_FLAGS = ["--n_per_device", "48", "--sigma_scale", "0.5",
             "--calibrate_target", str(CALIBRATE_TARGET), "--seed", str(SEED)]
#: (spec, kind, --max_scaled) of phase 20c.  dr_constant_icml's local K has
#: prior mean e (LogNormal mu 1), so its probe (locals at their prior mean)
#: peaks at e ~ 2.718 in OD whatever the shared sites: the study's 2.0 is out
#: of reach there in both packages (the JAX package's simulator also
#: calibrates to 2.718 and finds no shared draw in 1000 attempts), and 3.0 is
#: the first round bound above it
SIM_RUNS = ((SPEC_PREC, "dr_prec", 2.0), (SPEC, "dr", 3.0))
SIM_CALIBRATION_STEPS = 200
#: the JAX package's recorded recovery runs: (reports/ folder, source spec,
#: the forward kernel that decodes it)
RECORDED_TRUTHS = (("recovery_study", SPEC_ONE, "dr_fwd"),
                   ("recovery_precisions", SPEC_PREC, "dr_prec_fwd"))
# a decode of a recorded truth against the recorded x_noiseless / precisions,
# each series against its own largest magnitude: the JAX package's own CPU
# decode of the same files reaches 3.7e-6 / 3.0e-6 in x and 2.3e-4 in the
# learned precisions (they integrate to large values, where two backends
# round differently)
RECORDED_X_RTOL, RECORDED_PREC_RTOL = 1e-4, 1e-3
# the simulated CSV reloaded through build_datasets against the simulated
# observations (one float32 multiply / divide round trip)
CSV_RTOL = 2e-6


def simulator_launches(truth):
    """The forward launches of a calibrated, conditioned simulation whose
    truth npz is ``truth``: a forward a calibration step (a backward each
    too), then its probe; the eval decode's probe; stage A's attempts, stage
    B's rounds; the data's decode."""
    return (SIM_CALIBRATION_STEPS + 2 + int(truth["truth_attempt"]) + 1
            + int(truth["local_rounds"]) + 1 + 1)


def study_launches(args, spec):
    """The forward and backward launches of stages 2 and 3 of a recovery
    study at ``args`` on the derived ``spec``: one of each a training step,
    one forward an evaluation chunk of ``n_batch`` rows (both splits at
    every ``test_epoch``, every series at the end)."""
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.run_xval import create_parser

    targs = create_parser(True).parse_args([spec])
    targs.seed, targs.folds, targs.split = args.seed, args.folds, 1
    settings = Config(targs)
    data = build_datasets(targs, settings)
    n_batch = min(settings.params.n_batch, data.n_train)

    def chunks(n):
        return math.ceil(n / n_batch)

    steps = args.epochs * max(1, chunks(data.n_train))
    evals = ((args.epochs // args.test_epoch) * (chunks(data.n_train) + chunks(data.n_test))
             + chunks(data.n_train + data.n_test))
    return steps + evals, steps


def series_rel(got, ref):
    """max |got - ref| over each series' largest |ref| (arrays [L, ...])."""
    import numpy as np

    axes = tuple(range(1, ref.ndim))
    return float((np.abs(got - ref) / np.abs(ref).max(axis=axes, keepdims=True)).max())


def decode_numpy(sim, settings, program, truth, device, params):
    """``sim.make_decoder``'s decode of the truth npz's clipped theta on its
    design: numpy (x [L, S, T], precisions [L, S, T])."""
    import torch

    _, _, decode = sim.make_decoder(settings, program, truth["devices"], truth["treatments"],
                                    truth["times"], None, device=device, params_dec=params)
    x, prec = decode(truth["theta_clipped"][:, None, :])
    prec = torch.broadcast_to(prec, x.shape)
    return x.cpu().numpy()[:, 0], prec.cpu().numpy()[:, 0]


def probe_gradients(sim, settings, program, truth, device, params, g, solver, dtype, index,
                    w):
    """The calibration's backward on the truth npz's design, through
    ``solver`` in ``dtype``, at the probe of the shared center ``g`` (every
    series at u = g on the shared sites, its locals at their prior mean):
    (d |x| / d g for a one-hot cotangent at the flat ``index`` of x (the
    largest |x| where None), that index; d max|x| / d g as the calibration
    takes it (``torch.max``: ties share the cotangent evenly), the series
    that tie at the peak; d sum(w x) / d theta, each series' own theta
    [n_theta, L], a dense cotangent over every row).  Gradients float64 on
    the CPU."""
    import numpy as np
    import torch

    def cast(tree):
        return {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.to(dtype)

    settings.params.solver = solver
    _, _, decode = sim.make_decoder(settings, program, truth["devices"], truth["treatments"],
                                    truth["times"], None, eval_mode=False, device=device,
                                    params_dec=cast(params), dtype=dtype)
    shared = torch.as_tensor(sim._shared_site_mask(program), dtype=dtype, device=device)
    q = sim.truth_q(program, float(truth["sigma_scale"]), device)
    g = torch.as_tensor(np.asarray(g), dtype=dtype, device=device).requires_grad_(True)
    theta = sim._probe_theta(program, len(truth["devices"]), q, g * shared)
    x = decode(theta)[0].abs().flatten()
    if index is None:
        index = int(torch.argmax(x))
    (one_hot,) = torch.autograd.grad(x[index], g, retain_graph=True)
    peak = torch.max(x)
    ties = sorted({int(i) // (x.numel() // len(truth["devices"]))
                   for i in torch.nonzero(x == peak)[:, 0]})
    (at_max,) = torch.autograd.grad(peak, g)
    theta = theta.detach().requires_grad_(True)
    (per_series,) = torch.autograd.grad((decode(theta)[0] * w.to(dtype)).sum(), theta)
    return (one_hot.double().cpu(), index, at_max.double().cpu(), ties,
            per_series[:, 0].double().cpu().t())


def check_calibration(sim, settings, program, truth, device, params, phase, name):
    """The calibration's backward on its own operands, at g = 0 (its first
    step) and at the calibrated center, through the kernels against the
    plain midpoint route in float64, read as phase 3 reads a backward
    (``cotangent_readings``, BWD_NORM_TOL / BWD_P99_TOL; the plain float32
    route's readings beside):
      * the one-hot cotangent at float64's largest |x| (d |x| / d g over
        the shared sites; the first step's gradient up to its scalar
        2 (log peak - log target) / peak where the peak does not tie);
      * the calibration's own ``torch.max``, held where the kernels' tie
        set at the peak is float64's (float32 rounding can merge values
        1e-7 apart into one tie, as the plain float32 route does on
        dr_constant_one's probe, and then spreads the cotangent);
      * a dense seeded cotangent over every series (d / d theta, read site
        by site over the series), which reaches every row of the last,
        partial 32-row block.
    Fails the phase on a mismatch; returns the readings."""
    import numpy as np
    import torch

    shared = sim._shared_site_mask(program)
    n_series = len(truth["devices"])
    shape = (n_series, 1) + tuple(truth["x_noiseless"].shape[1:])
    w = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 18)).to(device)
    out = {}
    for label, g in (("g = 0", np.zeros(program.n_theta, np.float32)),
                     ("g = calibrated center", truth["u_center"])):
        ref = probe_gradients(sim, settings, program, truth, device, params, g, "midpoint",
                              torch.float64, None, w)
        index = ref[1]
        got = {route: probe_gradients(sim, settings, program, truth, device, params, g, solver,
                                      torch.float32, index, w)
               for route, solver in (("kernels", TRAIN_SOLVER), ("plain float32", "midpoint"))}

        def readings(a, b, sites=None):
            a, b = (a[None, sites], b[None, sites]) if sites is not None else (a, b)
            norm, p99 = cotangent_readings(a, b)
            return float(norm.max()), float(p99.max())

        row = {}
        for route, res in got.items():
            row[route] = dict(one_hot=readings(res[0], ref[0], shared),
                              at_max=readings(res[2], ref[2], shared), ties=res[3],
                              per_series=readings(res[4], ref[4]))
        k, kg = row["kernels"], got["kernels"]
        held_max = k["ties"] == ref[3]
        held = (k["one_hot"], k["per_series"]) + ((k["at_max"],) if held_max else ())
        ok = (bool(torch.isfinite(kg[0]).all() and torch.isfinite(kg[4]).all())
              and bool((kg[0][~shared] == 0).all())
              and all(v[0] <= BWD_NORM_TOL and v[1] <= BWD_P99_TOL for v in held))
        p = row["plain float32"]

        def series(rows):
            return "%d (%s%s)" % (len(rows), ", ".join(map(str, rows[:4])),
                                  ", ..." if len(rows) > 4 else "")

        print("  %s (%d series): normwise / p99 against the plain route in float64 (limits %g / "
              "%g), kernels then plain float32: one-hot at flat index %d %.3e / %.3e, %.3e / "
              "%.3e; torch.max (series tied at the peak: float64 %s, kernels %s, plain float32 "
              "%s; %s) %.3e / %.3e, %.3e / %.3e; dense cotangent, each site over the series "
              "%.3e / %.3e, %.3e / %.3e: %s"
              % (label, n_series, BWD_NORM_TOL, BWD_P99_TOL, index, *k["one_hot"],
                 *p["one_hot"],
                 series(ref[3]), series(k["ties"]), series(p["ties"]),
                 "held" if held_max else "another tie set: not held",
                 *k["at_max"], *p["at_max"], *k["per_series"], *p["per_series"], ok))
        if not ok:
            fail("phase %s: %s's calibration gradient through the kernels disagrees"
                 % (phase, name))
        out[label] = {route: dict(r, ties=len(r["ties"])) for route, r in row.items()}
    return out


def phase_simulate(device):
    """Phase 20c: the simulator (``simulate.main``) on ``dr_constant_precisions``
    (the ``dr_prec`` kernels) and ``dr_constant_icml`` (the ``dr`` kernels),
    each spec under ``solver: pallas_midpoint``, at the recovery study's
    flags (288 series): its launches (the backward once per calibration
    step) and walls; the kernel-route decode of the accepted theta against
    the plain generic midpoint decode; the CSV reloaded through
    ``build_datasets``; the global sites shared; the peaks (``SIM_RUNS``)."""
    import io

    import numpy as np
    import torch

    from vihds_tpu_torch import simulate as sim
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.convert import params_from_keystr
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.run_xval import create_parser

    out = {}
    for spec, kind, max_scaled in SIM_RUNS:
        name = os.path.basename(spec)[: -len(".yaml")]
        kernels = (kind + "_fwd", kind + "_bwd")
        with tempfile.TemporaryDirectory() as directory:
            src = write_spec(spec, directory, solver=TRAIN_SOLVER)
            out_dir = os.path.join(directory, "sim")
            for k in kernels:
                _counter(k).launches = 0
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                res = sim.main([src, "--output_dir", out_dir, "--max_scaled", str(max_scaled)]
                               + SIM_FLAGS, device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: _counter(k).launches for k in kernels}
            truth = dict(np.load(res.truth, allow_pickle=True))
            params = params_from_keystr(truth, device=device)
            settings = Config(sim.create_parser().parse_args([src, "--output_dir", out_dir]))
            decoded = {}
            for solver in (TRAIN_SOLVER, "midpoint"):
                settings.params.solver = solver
                decoded[solver] = decode_numpy(sim, settings, res.program, truth, device, params)
            checked = check_calibration(sim, settings, res.program, truth, device, params, "20c",
                                        name)
            targs = create_parser(True).parse_args([res.spec])
            targs.seed = SEED
            tset = Config(targs)
            ds = build_datasets(targs, tset).train.dataset
        (kx, kp), (px, pp) = decoded[TRAIN_SOLVER], decoded["midpoint"]
        x_ok = bool(np.isfinite(kx).all() and (np.abs(kx - px) <= KERNEL_ATOL
                                               + KERNEL_RTOL * np.abs(px)).all())
        p_ok = bool((np.abs(kp - pp) <= PREC_ATOL + PREC_RTOL * np.abs(pp)).all())
        x_rel = float((np.abs(kx - px) / np.maximum(np.abs(px), 1e-30)).max())
        same_as_written = bool(np.array_equal(kx, truth["x_noiseless"]))
        csv_rel = float((np.abs(ds.observations - res.observations)
                         / np.maximum(np.abs(res.observations), 1e-30)).max())
        csv_ok = ds.observations.shape == res.observations.shape and bool(np.allclose(
            ds.observations, res.observations, rtol=CSV_RTOL, atol=CSV_RTOL))
        g = res.program.global_slice
        shared = bool((truth["theta"][:, g] == truth["theta"][0:1, g]).all())
        a, r = int(truth["truth_attempt"]), int(truth["local_rounds"])
        want_fwd = simulator_launches(truth)
        secs = res.seconds
        print("phase 20c: simulate %s (%s; %d series x %d times; max_scaled %g): %.1f s wall "
              "(calibration %.2f s, rejection and decode %.2f s, writing %.2f s); shared draw "
              "accepted on attempt %d after calibration to probe peak %.3f (eval decode %.3f), "
              "%d local rounds, probe peak %.3f, noiseless peak %.3f; %s launches %d (%d "
              "expected: %d calibration steps + 2 probes + %d attempts + %d rounds + 1 decode), "
              "%s launches %d"
              % (name, TRAIN_SOLVER, len(res.devices), len(res.times), max_scaled, wall,
                 secs["calibrate"],
                 secs["reject"], secs["write"], a, float(truth["calibrated_peak"]),
                 float(truth["calibrated_peak_eval"]), r, float(truth["probe_peak"]),
                 float(truth["noiseless_peak"]), kernels[0], launches[kernels[0]], want_fwd,
                 SIM_CALIBRATION_STEPS, a + 1, r + 1, kernels[1], launches[kernels[1]]))
        print("  kernel-route decode == plain generic midpoint decode of the accepted theta: "
              "x rtol %g atol %g %s (max rel %.3e), precisions rtol %g atol %g %s; == the "
              "written x_noiseless bit for bit: %s; CSV reloaded through build_datasets == the "
              "observations within rtol %g: %s (max rel %.3e); global sites shared: %s"
              % (KERNEL_RTOL, KERNEL_ATOL, x_ok, x_rel, PREC_RTOL, PREC_ATOL, p_ok,
                 same_as_written, CSV_RTOL, csv_ok, csv_rel, shared))
        if launches[kernels[1]] != SIM_CALIBRATION_STEPS or launches[kernels[0]] != want_fwd:
            fail("phase 20c: %s launched %s" % (name, launches))
        if not (x_ok and p_ok and same_as_written and csv_ok and shared):
            fail("phase 20c: %s's simulation failed a check" % name)
        if not (float(truth["probe_peak"]) <= max_scaled
                and float(truth["noiseless_peak"]) <= max_scaled
                and 0.5 <= float(truth["calibrated_peak"]) <= max_scaled):
            fail("phase 20c: %s's peaks out of range" % name)
        out[kind] = dict(launches=launches, wall=wall, seconds=secs, max_scaled=max_scaled,
                         truth_attempt=a, local_rounds=r,
                         calibrated_peak=float(truth["calibrated_peak"]), calibration=checked)
    return out


def phase_recorded_truths(device):
    """Phase 20d: the JAX package's two recorded recovery truths
    (``reports/recovery_*/synthetic_truth.npz``: clipped theta, design,
    ``dec[...]`` params) decoded again through ``dr_fwd`` and
    ``dr_prec_fwd`` (``solver: pallas_midpoint``), against the recorded
    x_noiseless and precisions; reads only those data files."""
    import numpy as np

    from vihds_tpu_torch import simulate as sim
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.convert import params_from_keystr
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters

    out = {}
    for report, spec, kernel in RECORDED_TRUTHS:
        truth = dict(np.load(os.path.join(HERE, "reports", report, "synthetic_truth.npz"),
                             allow_pickle=True))
        with tempfile.TemporaryDirectory() as directory:
            src = write_spec(spec, directory, solver=TRAIN_SOLVER)
            settings = Config(sim.create_parser().parse_args([src, "--output_dir", directory]))
        program = ParamProgram(parse_parameters(settings.params))
        if list(truth["theta_names"]) != program.names:
            fail("phase 20d: %s's sites are not %s's" % (report, os.path.basename(spec)))
        _counter(kernel).launches = 0
        x, prec = decode_numpy(sim, settings, program, truth, device,
                               params_from_keystr(truth, device=device))
        launches = _counter(kernel).launches
        x_rel = series_rel(x, truth["x_noiseless"])
        p_rel = series_rel(prec, truth["precisions"])
        print("phase 20d: reports/%s (%d series x %d times) through %s: %d launch; x_noiseless "
              "max |diff| / series' largest %.3e (limit %g), precisions %.3e (limit %g)%s"
              % (report, x.shape[0], x.shape[2], kernel, launches, x_rel, RECORDED_X_RTOL, p_rel,
                 RECORDED_PREC_RTOL,
                 "; exact: %s" % np.array_equal(prec, truth["precisions"]) if p_rel == 0 else ""))
        if launches == 0 or not np.isfinite(x).all() or x_rel > RECORDED_X_RTOL \
                or p_rel > RECORDED_PREC_RTOL:
            fail("phase 20d: %s does not decode to its recorded truth" % report)
        out[kernel] = dict(launches=launches, x_rel=x_rel, prec_rel=p_rel)
    return out


RECOVERY_HEADLINE = ("median_abs_z", "coverage95", "predictive_coverage95",
                     "median_local_corr", "val_elbo")
#: the HMC stages' readings a report holds, printed beside the recorded ones
STAGE_READINGS = ("refine_accept", "refined_local_cover", "refine_ess_median", "refine_rhat_max",
                  "refine_disp_median", "pooled_accept", "pooled_local_cover",
                  "pooled_shared_cover", "pooled_ess_median", "pooled_rhat_max",
                  "pooled_disp_median")
STAGE_SECTIONS = ("## HMC-refined local sites (cut inference: shared sites ~ amortised q)",
                  "## Pooled joint HMC (the true hierarchical posterior)")
#: the steps of a sampler's repeat runs (two runs of one seed, bit for bit)
REPEAT_STEPS = 2
#: a pseudo-marginal log-likelihood through the kernels against the plain
#: route in float64, relative to each value (sums of 4 x T float32 terms)
LIK_RTOL = 1e-4


def sampler_launches(name, kw):
    """The forward and backward launches of one call of the sampler ``name``
    of ``vihds_tpu_torch.refine`` with keywords ``kw``, from its code: HMC
    (and Gibbs, whose locals move by HMC) a target at each step's start, a
    gradient per leapfrog point (n_leapfrog + 1), the target at the proposal
    (Gibbs: the shared block's proposal), then one gradient before the
    first step and one target after the last (Gibbs: its first target);
    the pseudo-marginal sampler two targets a step, one at the start and
    the final weights, forward only; SMC one target a temperature and n_moves
    HMC moves after it, each n_leapfrog + 3 targets, n_leapfrog + 1 of them
    gradients."""
    import inspect

    from vihds_tpu_torch import refine

    defaults = inspect.signature(getattr(refine, name)).parameters

    def get(k):
        return kw.get(k, defaults[k].default)

    if name == "pm_refine_shared":
        return 2 * get("n_steps") + 2, 0
    if name == "smc_refine":
        nl, moves = get("n_leapfrog"), get("n_moves")
        return get("n_temps") * (1 + moves * (nl + 3)), get("n_temps") * moves * (nl + 1)
    steps = get("n_sweeps") if name == "gibbs_refine_pooled" else get("n_steps")
    return steps * (get("n_leapfrog") + 3) + 2, steps * (get("n_leapfrog") + 1) + 1


def stage_launches(args):
    """(forward, backward) launches of the recovery study's HMC stages 3b and
    3c at ``args``."""
    out = [0, 0]
    for name, chains, steps in (("hmc_refine", args.refine_chains, args.refine_steps),
                                ("hmc_refine_pooled", args.pooled_chains, args.pooled_steps)):
        if chains:
            f, b = sampler_launches(name, dict(n_steps=steps))
            out[0] += f
            out[1] += b
    return tuple(out)


class SamplerCalls:
    """While active, records each call of the samplers of
    ``vihds_tpu_torch.refine``: (name, args, keywords, result, wall, the
    launches of ``kernels`` within the call)."""

    NAMES = ("hmc_refine", "hmc_refine_pooled", "gibbs_refine_pooled", "pm_refine_shared",
             "smc_refine")

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = []

    def __enter__(self):
        import torch

        from vihds_tpu_torch import refine

        self.saved = {name: getattr(refine, name) for name in self.NAMES}

        def wrap(name, fn):
            def call(*args, **kw):
                before = {k: _counter(k).launches for k in self.kernels}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fn(*args, **kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                self.calls.append(dict(name=name, args=args, kw=kw, res=res, wall=wall, launches={
                    k: _counter(k).launches - before[k] for k in self.kernels}))
                return res

            return call

        for name, fn in self.saved.items():
            setattr(refine, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        from vihds_tpu_torch import refine

        for name, fn in self.saved.items():
            setattr(refine, name, fn)
        return False


def _double(tree):
    return _map_tree(lambda v: v.double(), tree)


def refine_grad(model, program, params, batch, z, site_mask, solver, capture=None):
    """The z-gradients of the two terms of the samplers' log-joint at ``z``
    under ``solver`` (float64 where ``z`` is): (the data term's, d sum log
    p(x | T(z)) / d z, whose backward runs the kernels on a ``pallas_*``
    solver; the prior term's over the sampled sites).  ``capture`` (a list)
    receives the operands of the backward kernel launch
    (``fused_ode.kind_bwd``), detached."""
    import torch

    from vihds_tpu_torch import refine
    from vihds_tpu_torch.ops import fused_ode
    from vihds_tpu_torch.utils.attrdict import AttrDict

    if z.dtype == torch.float64:
        params, batch = _double(params), AttrDict((k, v.double()) for k, v in batch.items())
    mask = refine._sampled_mask(program, z) if site_mask is None else refine._host(site_mask, z)
    launch = fused_ode.kind_bwd

    def record(*args):
        capture.append([x.detach() if isinstance(x, torch.Tensor) else x for x in args])
        return launch(*args)

    old = model.ode_model.solver
    model.ode_model.solver = solver
    if capture is not None:
        fused_ode.kind_bwd = record
    try:
        log_lik = refine.make_log_lik(model, program, params, batch)
        g_lik = refine._grad(lambda z_: log_lik(refine.constrain_z(program, z_)))(z)
    finally:
        model.ode_model.solver = old
        fused_ode.kind_bwd = launch
    g_prior = refine._grad(lambda z_: (refine.log_prior_z_cols(program, z_) * mask).sum(-1))(z)
    return g_lik, g_prior


def refine_lik(model, program, params, batch, theta, solver):
    """The per-series log-likelihood [B, K] of ``theta`` under ``solver``
    (float64 where theta is), without a graph."""
    import torch

    from vihds_tpu_torch import refine
    from vihds_tpu_torch.utils.attrdict import AttrDict

    if theta.dtype == torch.float64:
        params, batch = _double(params), AttrDict((k, v.double()) for k, v in batch.items())
    old = model.ode_model.solver
    model.ode_model.solver = solver
    try:
        with torch.no_grad():
            return refine.make_log_lik(model, program, params, batch)(theta)
    finally:
        model.ode_model.solver = old


def _same(a, b):
    """Two samplers' outputs bit for bit (nested dicts of tensors)."""
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return a == b


def check_sampler(device, call, kind, phase, label):
    """One recorded sampler call on the card: its launches of ``kind``'s
    kernels against ``sampler_launches``; where it takes gradients, the
    z-gradient of the log-joint's data term (the share the kernels compute)
    through the kernels against the plain midpoint route in float64 at the
    chains' first and last z (each moved site over the rows:
    ``cotangent_readings`` at phase 3's backward limits), and the whole
    log-joint's normwise (near the posterior's mode its data and prior
    terms nearly cancel, so the relative error of its small elements reads
    the cancellation, not the kernels); each limit, normwise and percentile,
    is held where the plain float32 route meets it (elsewhere, as on a
    Gibbs chain's last shared sites, the float32 arithmetic around the
    kernel sets the reading, and the plain float32 route's readings stand
    beside); then the backward kernel on the last gradient's operands (the
    trajectory cotangent of R = series x chains rows, dense) against the
    plain sweep in float64, each limit held where the plain sweep in
    float32 meets it, its zero share and time beside the bound.  The pseudo-marginal sampler (no
    gradient): its log-likelihood at the returned theta against float64.
    Last, two repeat runs of the sampler (its steps cut to REPEAT_STEPS)
    with the call's seed, bit for bit.  Fails the phase on a mismatch;
    returns the readings."""
    import torch

    from vihds_tpu_torch import refine
    from vihds_tpu_torch.ops import fused_ode

    name, kw, res = call["name"], call["kw"], call["res"]
    model, program, params, batch, key = call["args"]
    fwd, bwd = kind + "_fwd", kind + "_bwd"
    want = sampler_launches(name, kw)
    got = (call["launches"][fwd], call["launches"][bwd])
    # the rows of a target: series x chains (SMC: particles; PM: x particles)
    chains = kw["n_particles"] if name == "smc_refine" else kw["n_chains"]
    per_chain = kw["n_particles"] if name == "pm_refine_shared" else 1
    out = dict(sampler=name, wall=call["wall"], launches=got, expected=want,
               rows=batch.observations.shape[0] * chains * per_chain)
    ok = got == want
    site_mask = kw.get("site_mask")
    moved = (torch.as_tensor(site_mask) > 0 if site_mask is not None
             else torch.as_tensor(~program.is_constant)).cpu()
    if name == "pm_refine_shared":
        theta = res.theta
        lk = refine_lik(model, program, params, batch, theta, TRAIN_SOLVER)
        lp = refine_lik(model, program, params, batch, theta.double(), "midpoint")
        rel = float(((lk.double() - lp).abs() / lp.abs().clamp_min(1e-300)).max())
        out["lik_rel"] = rel
        ok = ok and bool(torch.isfinite(lk).all()) and rel <= LIK_RTOL
        print("  %s %s (%s, R = %d a target): %.1f s, %s launches %d (%d expected), %s %d; the "
              "log-likelihood at the returned theta through the kernels against the plain route "
              "in float64: max rel %.3e (limit %g)"
              % (phase, label, name, out["rows"], call["wall"], fwd, got[0], want[0], bwd, got[1],
                 rel, LIK_RTOL))
    else:
        if name == "smc_refine":
            first = refine.init_z_from_q(model, program, params, batch,
                                         refine.Draws(key, device), chains)[0]
        else:
            first = res.z_init
        readings, operands = {}, []
        for where, z in (("first", first), ("last", res.z)):
            capture = operands if where == "last" else None
            lik32, prior32 = refine_grad(model, program, params, batch, z, site_mask,
                                         TRAIN_SOLVER, capture)
            lik64, prior64 = refine_grad(model, program, params, batch, z.double(), site_mask,
                                         "midpoint")
            n = z.shape[-1]

            def rows(g):  # each moved site over the rows
                return g.reshape(-1, n).t()[moved.to(g.device)]

            b = rows(lik64)
            keep = b.abs().amax(dim=1) > 0
            norm, p99 = cotangent_readings(rows(lik32)[keep], b[keep])
            joint, _ = cotangent_readings(rows(lik32 + prior32), rows(lik64 + prior64))
            readings[where] = dict(normwise=float(norm.max()), p99=float(p99.max()),
                                   joint_normwise=float(joint.max()), plain32=None,
                                   norm_held=True, p99_held=True)
            if float(p99.max()) > BWD_P99_TOL or float(norm.max()) > BWD_NORM_TOL:
                # each limit is held where the plain float32 route meets it: elsewhere
                # the float32 arithmetic around the kernels (clip, observe, the
                # log-likelihood) sets the reading, and the plain route's stands beside
                plain32, _ = refine_grad(model, program, params, batch, z, site_mask, "midpoint")
                p_norm, p_p99 = cotangent_readings(rows(plain32)[keep], b[keep])
                readings[where].update(plain32=(float(p_norm.max()), float(p_p99.max())),
                                       norm_held=float(p_norm.max()) <= BWD_NORM_TOL,
                                       p99_held=float(p_p99.max()) <= BWD_P99_TOL)
            r = readings[where]
            ok = (ok and bool(torch.isfinite(lik32).all())
                  and (not r["norm_held"] or float(norm.max()) <= BWD_NORM_TOL)
                  and (not r["p99_held"] or float(p99.max()) <= BWD_P99_TOL)
                  and (not r["norm_held"] or float(joint.max()) <= BWD_NORM_TOL))
        out["grad"] = readings
        k, wmat, packed, times, traj, g, method = operands[-1]
        T_, S, R = traj.shape
        with torch.no_grad():
            dw, dc, dy0 = fused_ode.kind_bwd(k, wmat, packed, times, traj, g, method)
            rw, rc, ry0 = fused_ode._plain_bwd(k, None if wmat is None else wmat.double(),
                                               packed.double(), times.double(), traj.double(),
                                               g.double(), method)
            got_b, ref_b = torch.cat([dc, dy0]), torch.cat([rc, ry0])
            norm, p99 = cotangent_readings(got_b, ref_b, True)
            # the weight cotangent, summed over the rows: normwise over the matrix
            w_rel = (float((dw.double() - rw).abs().max() / rw.abs().max())
                     if dw is not None else None)
            n_bytes = 4 * (2 * packed.numel() + times.numel() + 2 * T_ * S * R + S * R
                           + (wmat.numel() * (1 + -(-R // fused_ode.PREC_BWD_ROWS))
                              if wmat is not None else 0))
            ms = cuda_ms(lambda: fused_ode.kind_bwd(k, wmat, packed, times, traj, g, method), 20)
            bound_ms, bound_by = bound(n_bytes, flops_per_step(k)[1][method] * (T_ - 1) * R)
            b_plain32, b_norm_held, b_p99_held = None, True, True
            if float(norm.max()) > BWD_NORM_TOL or float(p99.max()) > BWD_P99_TOL:
                # the kernel's plain version in float32 on the same operands: each
                # limit is held where it meets it (elsewhere float32 sets the reading)
                _, pc, py0 = fused_ode._plain_bwd(k, wmat, packed, times, traj, g, method)
                p_norm, p_p99 = cotangent_readings(torch.cat([pc, py0]), ref_b, True)
                b_plain32 = (float(p_norm.max()), float(p_p99.max()))
                b_norm_held = b_plain32[0] <= BWD_NORM_TOL
                b_p99_held = b_plain32[1] <= BWD_P99_TOL
        zero = float((g == 0).double().mean())
        bwd_ok = (bool(torch.isfinite(got_b).all())
                  and (not b_norm_held or float(norm.max()) <= BWD_NORM_TOL)
                  and (not b_p99_held or float(p99.max()) <= BWD_P99_TOL)
                  and (w_rel is None or w_rel <= BWD_NORM_TOL))
        ok = ok and bwd_ok
        out["bwd"] = dict(rows=R, zero_share=zero, normwise=float(norm.max()),
                          p99=float(p99.max()), plain32=b_plain32, norm_held=b_norm_held,
                          p99_held=b_p99_held, dw_rel=w_rel, ms=ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        def grad_text(r):
            plain = ("; plain float32 normwise / p99 %.3e / %.3e" % r["plain32"]
                     if r["plain32"] else "")
            return "%.3e%s / %.3e%s (log-joint %.3e%s)" % (
                r["normwise"], "" if r["norm_held"] else " not held", r["p99"],
                "" if r["p99_held"] else " not held", r["joint_normwise"], plain)

        rb = out["bwd"]
        bwd_plain = ("; plain float32 %.3e%s / %.3e%s" % (
            rb["plain32"][0], "" if rb["norm_held"] else " (normwise not held)",
            rb["plain32"][1], "" if rb["p99_held"] else " (p99 not held)")
            if rb["plain32"] else "")

        print("  %s %s (%s, R = %d): %.1f s, %s launches %d (%d expected), %s %d (%d expected); "
              "z-gradient of the data term through the kernels against the plain route in "
              "float64, normwise / p99 (limits %g / %g) at the first step %s, at the last %s; %s "
              "on the last gradient's operands (T=%d, R=%d; cotangent %.4f exactly zero) against "
              "the plain sweep in float64: worst normwise %.3e, worst p99 %.3e%s%s; kernel %.4f "
              "ms  bound %.4f ms (%s)"
              % (phase, label, name, out["rows"], call["wall"], fwd, got[0], want[0], bwd, got[1],
                 want[1], BWD_NORM_TOL, BWD_P99_TOL, grad_text(readings["first"]),
                 grad_text(readings["last"]), bwd, T_, R, zero, float(norm.max()),
                 float(p99.max()), bwd_plain, ", dW %.3e" % w_rel if w_rel is not None else "",
                 ms, bound_ms, bound_by))
    steps = {"gibbs_refine_pooled": "n_sweeps", "smc_refine": "n_temps"}.get(name, "n_steps")
    short = dict(kw, **{steps: min(REPEAT_STEPS, kw.get(steps, REPEAT_STEPS))})
    fn = getattr(refine, name)
    repeats = [fn(model, program, params, batch, key, **short) for _ in range(2)]
    out["repeat_equal"] = _same(repeats[0], repeats[1])
    print("    two runs of seed %s at %d %s bit-equal: %s" % (key, short[steps], steps[2:],
                                                            out["repeat_equal"]))
    if not (ok and out["repeat_equal"]):
        fail("phase %s: the %s stage (%s) failed a check" % (phase, label, name))
    return out


def run_study(device, directory, run, argv, kind="dr"):
    """``run`` (the study's ``main``, or its stages 2-3 on a recorded
    simulation) with INFERENCE_RESULTS_DIR under ``directory``, the
    ``kind``'s counts set to 0 just before, each call of the HMC samplers
    recorded (``SamplerCalls``): (summary, wall, launches, the captured
    output's lines, the sampler calls)."""
    import io

    import torch

    kernels = (kind + "_fwd", kind + "_bwd")
    os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(directory, "results")
    for k in kernels:
        _counter(k).launches = 0
    text = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(text), SamplerCalls(kernels) as calls:
            summary = run(argv)
        torch.cuda.synchronize()
    finally:
        del os.environ["INFERENCE_RESULTS_DIR"]
    wall = time.perf_counter() - t0
    launches = {k: _counter(k).launches for k in kernels}
    return summary, wall, launches, text.getvalue().splitlines(), calls.calls


def report_study(phase, what, args, summary, wall, launches, log, outdir, want, kind="dr"):
    """Print a study's wall, the ``kind``'s launches (against ``want``, the
    expected (forward, backward)), files and headline; fail where REPORT.md
    or recovery.npz is missing, the headline is not finite or the launches
    differ.  Returns the headline."""
    import numpy as np

    written = sorted(os.listdir(outdir))
    rec_keys = sorted(np.load(os.path.join(outdir, "recovery.npz"), allow_pickle=True).files) \
        if "recovery.npz" in written else []
    report = open(os.path.join(outdir, "REPORT.md")).read() if "REPORT.md" in written else ""
    epochs = [line for line in log if line.startswith("epoch")]
    headline = {k: summary[k] for k in RECOVERY_HEADLINE}
    fwd, bwd = kind + "_fwd", kind + "_bwd"
    print("phase %s: %s (%s, %d series, %d epochs, K %d / %d, test_epoch %d; HMC stages %d x %d "
          "and %d x %d): %.1f s wall; %d evaluation lines, the last: %s; %s launches %d, %s "
          "launches %d (%d / %d expected); wrote %s; recovery.npz keys %s"
          % (phase, what, TRAIN_SOLVER, summary["n_series"], args.epochs, args.train_samples,
             args.test_samples, args.test_epoch, args.refine_chains, args.refine_steps,
             args.pooled_chains, args.pooled_steps, wall, len(epochs),
             epochs[-1] if epochs else None, fwd, launches[fwd], bwd, launches[bwd], want[0],
             want[1], written, rec_keys))
    print("phase %s: headline %s" % (phase, json.dumps(headline)))
    for line in report.splitlines():
        if line.startswith("| ") and "|---" not in line and "## " not in line and \
                ("median abs z (truth" in line or "coverage" in line or "corr(q_mu" in line
                 or "IWAE-ELBO" in line):
            print("  " + line)
    if not {"REPORT.md", "recovery.npz"} <= set(written) or not all(
            v is not None and np.isfinite(v) for v in headline.values()):
        fail("phase %s: the recovery study wrote %s, headline %s" % (phase, written, headline))
    if (launches[fwd], launches[bwd]) != tuple(want):
        fail("phase %s: the study launched %s, not %s" % (phase, launches, want))
    recorded_keys = np.load(os.path.join(HERE, "reports", "recovery_study", "recovery.npz"),
                            allow_pickle=True).files
    if set(rec_keys) != set(recorded_keys):
        fail("phase %s: recovery.npz holds %s, the tool's recorded run %s"
             % (phase, rec_keys, sorted(recorded_keys)))
    for line in report.splitlines():
        if line.startswith("| HMC-refined") or line.startswith("| pooled-joint"):
            print("  " + line)
    if not all(section in report for section in STAGE_SECTIONS):
        fail("phase %s: REPORT.md lacks the HMC stages' sections" % phase)
    return headline


def check_stages(device, calls, kind, phase):
    """``check_sampler`` on the study's two HMC stages (3b ``hmc_refine``,
    3c ``hmc_refine_pooled``): {stage: readings}."""
    labels = {"hmc_refine": "3b", "hmc_refine_pooled": "3c"}
    if sorted(c["name"] for c in calls) != sorted(labels):
        fail("phase %s: the study called %s" % (phase, [c["name"] for c in calls]))
    return {labels[c["name"]]: check_sampler(device, c, kind, phase, labels[c["name"]])
            for c in calls}


def phase_recovery(device):
    """Phase 20e: ``recovery_study.main`` on ``dr_constant_one`` under
    ``solver: pallas_midpoint`` at its widths and ``STUDY_DEPTH``, HMC
    stages 3b (64 chains x 60 steps) and 3c (32 x 90) included: REPORT.md and recovery.npz
    written with the tool's keys and sections, a finite headline, the wall
    and the ``dr`` kernels' launches, each the count the simulator, the
    steps, the evaluation chunks and the stages make; each stage's
    ``check_sampler``; then the calibration's backward on this design (48
    series: a last 32-row block half full) against the plain route
    (``check_calibration``).  Returns the readings and, as ``source``, the
    trained model, params and batch of stage 3b (phase 20h's)."""
    import numpy as np

    from vihds_tpu_torch import recovery_study as rs
    from vihds_tpu_torch import simulate as sim
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.convert import params_from_keystr
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters

    with tempfile.TemporaryDirectory() as directory:
        src = write_spec(SPEC_ONE, directory, solver=TRAIN_SOLVER)
        outdir = os.path.join(directory, "study")
        argv = ["--spec", src, "--outdir", outdir] + STUDY_DEPTH
        summary, wall, launches, log, calls = run_study(
            device, directory, lambda a: rs.main(a, device=device), argv)
        args = rs.parse(argv)
        truth = dict(np.load(os.path.join(outdir, "synthetic_truth.npz"), allow_pickle=True))
        os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(directory, "results")
        fwd, bwd = study_launches(args, os.path.join(outdir, "synthetic.yaml"))
        del os.environ["INFERENCE_RESULTS_DIR"]
        s_fwd, s_bwd = stage_launches(args)
        want = (simulator_launches(truth) + fwd + s_fwd, SIM_CALIBRATION_STEPS + bwd + s_bwd)
        headline = report_study("20e", "recovery_study on dr_constant_one", args, summary, wall,
                                launches, log, outdir, want)
        settings = Config(sim.create_parser().parse_args([src, "--output_dir", directory]))
    print("phase 20e: the stages' readings %s"
          % json.dumps({k: summary[k] for k in STAGE_READINGS}))
    stages = check_stages(device, calls, "dr", "20e")
    program = ParamProgram(parse_parameters(settings.params))
    checked = check_calibration(sim, settings, program, truth, device,
                                params_from_keystr(truth, device=device), "20e", "dr_constant_one")
    c3b = next(c for c in calls if c["name"] == "hmc_refine")
    c3c = next(c for c in calls if c["name"] == "hmc_refine_pooled")
    source = dict(args=c3b["args"][:4], devices=c3c["kw"]["devices"])
    return dict(wall=wall, launches=launches, headline=headline, epochs=args.epochs,
                calibration=checked, stages=stages,
                readings={k: summary[k] for k in STAGE_READINGS}, source=source)


#: phase 20e: the study's depth cut to keep the script within its time
#: limit (its widths, chains and series, are the study's defaults): 400 of
#: its 1000 training epochs, 60 / 90 of its stages' 200 / 300 HMC steps
STUDY_DEPTH = ["--epochs", "400", "--refine_steps", "60", "--pooled_steps", "90"]
#: phases 20f and 20g: (phase, reports/ folder, source spec, fused kind,
#: training epochs, HMC steps of stages 3b / 3c).  The depth is cut to keep
#: the script within its time limit (the widths, chains and series, are the
#: study's): 20f trains 300 of the study's 1000 epochs and runs 40 / 60 of
#: the stages' 200 / 300 steps; 20g trains 125 (750 of 6000 steps on 216
#: series) and runs 100 / 150 (cut further, to 75 epochs and 40 / 60
#: steps, its last pooled chains' z-gradient and ``dr_prec_bwd`` on their
#: operands read 1.46e-4 / 2.68e-4 normwise against float64, and the plain
#: float32 route and sweep the same: float32's, so ``check_sampler`` holds
#: the normwise limit where the plain route meets it;
#: ``tools/recorded_study_check.py`` runs that depth)
RECORDED_STUDIES = (("20f", "recovery_study", SPEC_ONE, "dr", 300, (40, 60)),
                    ("20g", "recovery_precisions", SPEC_PREC, "dr_prec", 125, (100, 150)))


def phase_recorded_study(device, phase, report, spec_src, kind, epochs, steps=None):
    """Phases 20f / 20g: the study's stages 2-3, HMC stages included
    (``recovery_study.train_and_score``), on the JAX package's recorded
    simulation under ``reports/<report>`` (its CSV and truth npz; its spec
    under ``solver: pallas_midpoint``, ``files`` pointed at the CSV), at
    ``epochs`` and the stages' ``steps`` (3b, 3c; default the study's): the
    same data and truth as the recorded report, so its headline and the
    stages' readings stand beside the recorded ones (the recorded run's HMC
    steps read from its REPORT.md).  Checks as 20e: the files, a finite
    headline, the ``kind``'s launches, ``check_sampler`` on each stage."""
    import re
    import shutil

    import numpy as np
    import yaml

    from vihds_tpu_torch import recovery_study as rs

    recorded = os.path.join(HERE, "reports", report)
    with tempfile.TemporaryDirectory() as directory:
        data_dir = os.path.join(directory, "recorded")
        os.makedirs(data_dir)
        for name in ("synthetic.csv", "synthetic_truth.npz"):
            shutil.copy(os.path.join(recorded, name), data_dir)
        with open(os.path.join(recorded, "synthetic.yaml")) as f:
            config = yaml.safe_load(f)
        config["data"]["files"] = [os.path.join(data_dir, "synthetic.csv")]
        config["params"]["solver"] = TRAIN_SOLVER
        spec = os.path.join(data_dir, "synthetic.yaml")
        with open(spec, "w") as f:
            yaml.safe_dump(config, f, sort_keys=False)
        truth_path = os.path.join(data_dir, "synthetic_truth.npz")
        outdir = os.path.join(directory, "study")
        argv = ["--spec", spec_src, "--outdir", outdir, "--epochs", str(epochs)]
        if steps is not None:
            argv += ["--refine_steps", str(steps[0]), "--pooled_steps", str(steps[1])]
        args = rs.parse(argv)
        summary, wall, launches, log, calls = run_study(
            device, directory, lambda a: rs.train_and_score(a, spec, truth_path, device), args,
            kind)
        os.environ["INFERENCE_RESULTS_DIR"] = os.path.join(directory, "results")
        fwd, bwd = study_launches(args, spec)
        del os.environ["INFERENCE_RESULTS_DIR"]
        s_fwd, s_bwd = stage_launches(args)
        headline = report_study(phase, "stages 2-3 on reports/%s's simulation" % report, args,
                                summary, wall, launches, log, outdir, (fwd + s_fwd, bwd + s_bwd),
                                kind)
    reference = np.load(os.path.join(recorded, "recovery.npz"), allow_pickle=True)
    ref = {k: float(reference[k]) for k in RECOVERY_HEADLINE}
    text = open(os.path.join(recorded, "REPORT.md")).read()
    ref_steps = tuple(int(re.search(r"--%s (\d+)" % flag, text).group(1))
                      for flag in ("refine_steps", "pooled_steps"))
    print("phase %s: the recorded report's headline on the same data and truth (the JAX "
          "package, its own training draws, %d epochs; statistics, not speeds): %s"
          % (phase, int(reference["epochs"]), json.dumps(ref)))
    readings = {k: summary[k] for k in STAGE_READINGS}
    ref_readings = {k: float(reference[k]) for k in STAGE_READINGS}
    print("phase %s: the HMC stages' readings at %d / %d steps %s; the recorded report's at %d / "
          "%d steps %s" % (phase, args.refine_steps, args.pooled_steps, json.dumps(readings),
                           *ref_steps, json.dumps(ref_readings)))
    stages = check_stages(device, calls, kind, phase)
    return dict(wall=wall, launches=launches, headline=headline, recorded_headline=ref,
                stages=stages, readings=readings, recorded_readings=ref_readings,
                recorded_steps=ref_steps)


#: phase 20h: the other samplers at the tools' widths on 20e's trained model
#: (tools/refine_demo.py:61-67 on 12 series, seed 7;
#: tools/ar_mu_ground_truth.py:210-230 on every series, seed + 101), their
#: steps cut to ~50: (sampler, series, seed, keywords)
OTHER_SAMPLERS = (
    ("smc_refine", 12, 7, dict(n_particles=64, n_temps=8, n_moves=2)),
    ("hmc_refine", 12, 7, dict(n_chains=64, n_steps=30)),
    ("gibbs_refine_pooled", None, 101, dict(n_chains=16, n_sweeps=50, n_leapfrog=10,
                                            return_trace=True)),
    ("pm_refine_shared", None, 101, dict(n_chains=16, n_steps=50, n_particles=64, rho=0.98,
                                         return_trace=True)),
)


def phase_other_samplers(device, source):
    """Phase 20h: SMC, HMC, pooled Gibbs and the pseudo-marginal sampler of
    ``vihds_tpu_torch.refine`` on phase 20e's trained ``dr_constant_one``
    model under ``solver: pallas_midpoint`` (``OTHER_SAMPLERS``), the ``dr``
    counts set to 0 just before: each run's outputs finite, then
    ``check_sampler``.  Returns {sampler: readings}."""
    import torch

    from vihds_tpu_torch import refine
    from vihds_tpu_torch.utils.attrdict import AttrDict

    model, program, params, batch = source["args"]
    kernels = ("dr_fwd", "dr_bwd")
    for k in kernels:
        _counter(k).launches = 0
    with SamplerCalls(kernels) as rec:
        for name, series, seed, kw in OTHER_SAMPLERS:
            b = batch if series is None else AttrDict(
                (k, v if k == "times" else v[:series]) for k, v in batch.items())
            if name in ("gibbs_refine_pooled", "pm_refine_shared"):
                kw = dict(kw, devices=source["devices"])
            getattr(refine, name)(model, program, params, b, seed, **kw)
    launches = {k: _counter(k).launches for k in kernels}
    out = {}
    for call in rec.calls:
        res = call["res"]
        finite = all(bool(torch.isfinite(v).all()) for v in res.values()
                     if isinstance(v, torch.Tensor))
        extra = {
            "smc_refine": lambda: "log evidence mean %.2f, ESS at the last temperature mean %.1f"
            % (float(res.log_evidence.mean()), float(res.ess_trace[-1].mean())),
            "hmc_refine": lambda: "accept %.3f, median log-joint %.1f -> %.1f"
            % (float(res.accept_rate.mean()), float(res.log_joint_trace[0]),
               float(res.log_joint_trace[-1])),
            "gibbs_refine_pooled": lambda: "accept shared %.3f, local %.3f"
            % (float(res.accept_rate.mean()), float(res.accept_rate_local.mean())),
            "pm_refine_shared": lambda: "accept shared %.3f, particle refresh %.3f"
            % (float(res.accept_rate.mean()), float(res.accept_rate_u.mean())),
        }[call["name"]]()
        shown = {k: v for k, v in call["kw"].items() if k != "devices"}
        print("phase 20h: %s on %d series (%s): %.1f s; %s; outputs finite: %s"
              % (call["name"], call["args"][3].observations.shape[0], json.dumps(shown),
                 call["wall"], extra, finite))
        if not finite:
            fail("phase 20h: %s returned non-finite outputs" % call["name"])
        out[call["name"]] = check_sampler(device, call, "dr", "20h", call["name"])
    print("phase 20h: dr_fwd launches %d, dr_bwd launches %d over the four samplers" % (
        launches["dr_fwd"], launches["dr_bwd"]))
    if launches["dr_fwd"] != sum(r["launches"][0] for r in out.values()):
        fail("phase 20h: launches outside the samplers: %s" % launches)
    return dict(launches=launches, samplers=out)


#: phase 20i: the samplers over the mesh's ranks, at phase 20h's widths and
#: a cut depth (HMC 10 of its 60 steps, SMC 4 of its 16 temperatures), on
#: the first series of the request phase 20i serves: (sampler, seed, keywords)
MESH_SAMPLERS = (("hmc_refine", 7, dict(n_chains=64, n_steps=10)),
                 ("smc_refine", 7, dict(n_particles=64, n_temps=4, n_moves=2)))
MESH_SERIES = 12
#: the line a phase 20i process prints its readings on
REFINE_RANK_LINE = "phase 20i rank: "
#: phase 20i: the served moments (sums over K, added in halves by the two
#: sample ranks) against the one process's
MESH_IW_RTOL, MESH_IW_ATOL = 1e-5, 1e-6


def refine_rank_main(argv):
    """One process of phase 20i: ``CFG RANK WORLD PORT PORT2``.  With WORLD 2
    it is one rank: ``predict.main`` on CFG's request with ``--mesh_sample 2
    --distributed 127.0.0.1:PORT,2,RANK``, then, in a second process group
    at PORT2, each of ``MESH_SAMPLERS`` under a (1, 2) mesh on the first
    ``MESH_SERIES`` series of the request; with WORLD 1 the same without a
    mesh, the one-process reference.  The ``dr`` counts are set to 0 just
    before each; it writes its samplers' outputs and prints one
    ``REFINE_RANK_LINE`` with the launches and rows a launch of each."""
    import collections

    import numpy as np
    import torch

    from vihds_tpu_torch import parallel, predict as P, refine
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.ops import fused_ode
    from vihds_tpu_torch.parallel import multihost
    from vihds_tpu_torch.prob import ParamProgram, parse_parameters
    from vihds_tpu_torch.training import batch_tensors
    from vihds_tpu_torch.vae import VAE, params_to

    cfg_path, rank, world, port, port2 = argv[0], *map(int, argv[1:5])
    with open(cfg_path) as f:
        cfg = json.load(f)
    label = "rank%d" % rank if world > 1 else "one"
    rows = {"dr_fwd": collections.Counter(), "dr_bwd": collections.Counter()}
    kind_fwd, kind_bwd = fused_ode.kind_fwd, fused_ode.kind_bwd

    def fwd(kind, wmat, packed, *a):
        rows[kind + "_fwd"][int(packed.shape[1])] += 1
        return kind_fwd(kind, wmat, packed, *a)

    def bwd(kind, wmat, packed, *a):
        rows[kind + "_bwd"][int(packed.shape[1])] += 1
        return kind_bwd(kind, wmat, packed, *a)

    fused_ode.kind_fwd, fused_ode.kind_bwd = fwd, bwd

    def reset():
        for k, c in rows.items():
            _counter(k).launches = 0
            c.clear()

    device = torch.device(cfg["device"])

    def reading(t0):
        if device.type == "cuda":
            torch.cuda.synchronize()
        return dict(wall=time.perf_counter() - t0,
                    launches={k: _counter(k).launches for k in rows},
                    rows={k: {str(r): n for r, n in sorted(c.items())} for k, c in rows.items()})

    readings = {}
    request = cfg["predict"] + ["--output", os.path.join(cfg["dir"], label + ".npz")]
    if world > 1:
        request += ["--mesh_sample", str(world), "--distributed",
                    "127.0.0.1:%d,%d,%d" % (port, world, rank)]
    reset()
    t0 = time.perf_counter()
    served = P.main(request, device=cfg["device"])
    readings["predict"] = reading(t0)

    mesh = None
    if world > 1:
        _, _, device = multihost.initialize("tcp://127.0.0.1:%d" % port2, world, rank,
                                            device=cfg["device"])
        mesh = parallel.make_mesh(1, world, device=device)
    args = P.create_parser().parse_args(cfg["predict"])
    args.heldout = None
    settings = Config(args)
    model = VAE(settings, build_datasets(args, settings),
                ParamProgram(parse_parameters(settings.params)))
    params = params_to(P.restore_params(args.checkpoint)[1], device)
    host = served.host
    times = torch.as_tensor(host.times, dtype=torch.float32, device=device)
    batch = batch_tensors(host, np.arange(MESH_SERIES), times, device)
    outputs = {}
    with parallel.use_mesh(mesh):
        for name, seed, kw in MESH_SAMPLERS:
            reset()
            t0 = time.perf_counter()
            res = getattr(refine, name)(model, model.program, params, batch, seed, **kw)
            readings[name] = reading(t0)
            outputs.update({"%s/%s" % (name, k): v.cpu().numpy() for k, v in res.items()
                            if isinstance(v, torch.Tensor)})
    np.savez(os.path.join(cfg["dir"], label + "_samplers.npz"), **outputs)
    print(REFINE_RANK_LINE + json.dumps(dict(rank=rank, world=world, readings=readings)),
          flush=True)
    multihost.shutdown()
    return 0


def phase_refine_mesh(device, ckpt_dir):
    """Phase 20i: serving and refinement over the mesh's ranks: one launch
    of 2 gloo ranks sharing the card (``refine_rank_main``) beside the
    one-process reference (a third process): ``predict.main --mesh_sample 2``
    on phase 14's checkpoint (one request at K=1000 under ``pallas_midpoint``),
    then ``MESH_SAMPLERS`` over a (1, 2) mesh.  Each rank's ``dr`` launches and
    rows a launch against the prediction (``sampler_launches``; the request's
    chunk at R = 36 x 1000 / 2), rank 0 alone writing the npz; the npz
    against the reference's (bit for bit but the moments, ``MESH_IW_RTOL``),
    the samplers' outputs of both ranks against the reference's bit for bit."""
    import numpy as np

    with tempfile.TemporaryDirectory() as directory:
        spec = write_spec(SPEC_UNMERGED, directory, solver=TRAIN_SOLVER,
                          eval_solver=TRAIN_SOLVER)
        cfg = dict(dir=directory, device=str(device),
                   predict=[spec, "--checkpoint", ckpt_dir, "--data", REQUESTS[0],
                            "--test_samples", str(K_SERVE), "--seed", str(SEED)])
        cfg_path = os.path.join(directory, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        cwd = os.path.join(directory, "cwd")
        os.makedirs(cwd)
        port, port2 = _free_port(), _free_port()
        code = "import sys, chip_smoke; sys.exit(chip_smoke.refine_rank_main(sys.argv[1:]))"
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, cfg_path] + list(map(str, a)),
                                  cwd=cwd, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for a in ((0, 2, port, port2), (1, 2, port, port2), (0, 1, 0, 0))]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, DIST_WALL
                                                      - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            fail("phase 20i: a process ran past %d s" % DIST_WALL)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        readings = {}
        for label, p, (out, err) in zip(("rank0", "rank1", "one"), procs, outs):
            line = [ln for ln in out.splitlines() if ln.startswith(REFINE_RANK_LINE)]
            if p.returncode != 0 or len(line) != 1:
                fail("phase 20i: %s exited %s:\n%s\n%s" % (label, p.returncode, out[-3000:],
                                                          err[-3000:]))
            readings[label] = json.loads(line[0][len(REFINE_RANK_LINE):])["readings"]
        if os.path.exists(os.path.join(directory, "rank1.npz")) or os.listdir(cwd):
            fail("phase 20i: rank 1 wrote %s" % os.listdir(cwd))
        npz = {label: dict(np.load(os.path.join(directory, label + ".npz"), allow_pickle=True))
               for label in ("rank0", "one")}
        samplers = {label: dict(np.load(os.path.join(directory, label + "_samplers.npz")))
                    for label in ("rank0", "rank1", "one")}
    want = {"predict": ((1, 0), {"dr_fwd": {str(36 * K_SERVE // 2): 1}, "dr_bwd": {}})}
    for name, _, kw in MESH_SAMPLERS:
        f, b = sampler_launches(name, kw)
        R = MESH_SERIES * kw.get("n_chains", kw.get("n_particles")) // 2
        want[name] = ((f, b), {"dr_fwd": {str(R): f}, "dr_bwd": {str(R): b}})
    for label in ("rank0", "rank1"):
        for path, ((f, b), want_rows) in want.items():
            got = readings[label][path]
            print("phase 20i: %s, %s: dr_fwd launches %d, dr_bwd launches %d (predicted %d / %d); "
                  "rows a launch %s (predicted %s); %.2f s (one process %.2f s)"
                  % (label, path, got["launches"]["dr_fwd"], got["launches"]["dr_bwd"], f, b,
                     json.dumps(got["rows"]), json.dumps(want_rows), got["wall"],
                     readings["one"][path]["wall"]))
            if (got["launches"]["dr_fwd"], got["launches"]["dr_bwd"]) != (f, b) \
                    or got["rows"] != want_rows:
                fail("phase 20i: %s's %s launches or rows differ from the prediction"
                     % (label, path))
    mesh_npz, one_npz = npz["rank0"], npz["one"]
    iw = ("iw_predict_mu", "iw_predict_std", "iw_states", "iw_variance")
    differ = [k for k in one_npz if k not in iw and not np.array_equal(mesh_npz[k], one_npz[k])]
    iw_diff = {k: float(np.max(np.abs(mesh_npz[k] - one_npz[k]))) for k in iw}
    iw_close = all(np.allclose(mesh_npz[k], one_npz[k], rtol=MESH_IW_RTOL, atol=MESH_IW_ATOL)
                   for k in iw)
    keys = sorted(samplers["one"])
    unequal = [k for k in keys for label in ("rank0", "rank1")
               if not np.array_equal(samplers[label][k], samplers["one"][k])]
    finite = all(np.isfinite(samplers["one"][k]).all() for k in keys
                 if samplers["one"][k].dtype.kind == "f")
    print("phase 20i: 2 gloo ranks and the one-process reference, %.1f s wall; rank 0 alone "
          "wrote; the npz against one process: bit-equal but %s, the moments' max |diff| %s "
          "(rtol %g atol %g: %s); the samplers' %d outputs of both ranks bit-equal to one "
          "process: %s; finite: %s"
          % (wall, differ or "none", json.dumps({k: "%.3e" % v for k, v in iw_diff.items()}),
             MESH_IW_RTOL, MESH_IW_ATOL, iw_close, len(keys), not unequal, finite))
    if differ or not iw_close or unequal or not finite:
        fail("phase 20i: the ranks' outputs differ from one process's: %s %s" % (differ,
                                                                                  unequal[:5]))
    return dict(wall=wall, readings=readings, iw_diff=iw_diff)


#: phases 20j-20n: the research tools (``vihds_tpu_torch.tools``), each on a
#: copy of its spec under ``solver: pallas_midpoint``.  20j runs
#: ``refine_demo`` at its own depth (64 particles, 16 temperatures x 2
#: moves, 60 HMC steps, 12 series); the others' depth is cut to keep the
#: script within its time limit (their widths, chains and series, are the
#: tools'): ``ar_mu_ground_truth`` trains 40 of its 1000 epochs and samples
#: 40 of its 3000 steps (sweeps), ``icml_site_mechanism`` ridge 20 of 1000
#: epochs and 20 of 4000 steps and drift the grid (10, 20) of (1000, 2000,
#: 4000), ``posterior_parity ours`` 2 seeds of 40 of its 300 epochs
TOOLS_DEPTH = {"20k": dict(epochs=40, n_steps=40), "20l": dict(epochs=20, n_steps=20,
                                                              grid=[10, 20]),
               "20m": dict(epochs=40, seeds=[0, 1])}
#: phase 20k: the routes of ``ar_mu_ground_truth run``: (route, seed); the
#: seeds follow the recorded ``reports/ar_mu_ground_truth_r5`` seeds 0-5,
#: which phase 20k's report reads beside them
ARMU_ROUTES = (("perseries", 6), ("gibbs", 7))
#: the recorded posterior-parity battery that phase 20m compares with
PARITY_RECORDED = os.path.join(HERE, "reports", "posterior_parity_ctrl_unit")


def run_tool(run, kinds=("dr_fwd", "dr_bwd")):
    """``run()`` with the ``kinds``' counts set to 0 just before and its
    standard output captured: (its result, wall, launches, output lines)."""
    import io

    import torch

    for k in kinds:
        _counter(k).launches = 0
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return result, wall, {k: _counter(k).launches for k in kinds}, text.getvalue().splitlines()


def tool_training_launches(spec, seed, epochs, test_epoch=20):
    """The forward and backward launches of a tool's training of ``spec``
    (split 1 of 4) for ``epochs``: one of each a step, one forward an
    evaluation chunk of ``n_batch`` rows (both splits every ``test_epoch``,
    clamped to ``epochs``)."""
    from vihds_tpu_torch.config import Config
    from vihds_tpu_torch.data.datasets import build_datasets
    from vihds_tpu_torch.run_xval import create_parser

    args = create_parser(True).parse_args([spec])
    args.seed = seed
    settings = Config(args)
    data = build_datasets(args, settings)
    n_batch = min(settings.params.n_batch, data.n_train)
    steps = epochs * math.ceil(data.n_train / n_batch)
    evals = (epochs // min(test_epoch, epochs)) * (math.ceil(data.n_train / n_batch)
                                                   + math.ceil(data.n_test / n_batch))
    return steps + evals, steps


def check_tool_launches(phase, what, launches, want):
    """Print ``what``'s ``dr`` launches beside ``want`` (forward, backward);
    fail where they differ."""
    print("phase %s: %s: dr_fwd launches %d, dr_bwd launches %d (predicted %d / %d)"
          % (phase, what, launches["dr_fwd"], launches["dr_bwd"], *want))
    if (launches["dr_fwd"], launches["dr_bwd"]) != tuple(want):
        fail("phase %s: %s launched the dr kernels %s times, not %s" % (phase, what, launches,
                                                                         want))


def phase_refine_demo(device, ckpt_dir):
    """Phase 20j: ``tools.refine_demo`` on phase 14's checkpoint
    (``dr_constant_icml_unmerged`` under ``solver: pallas_midpoint``) at the
    tool's depth: the IWAE bound at K = 64, ``smc_refine`` and
    ``hmc_refine`` on the first 12 test series (R = 768), the ``dr``
    launches against ``sampler_launches`` plus the IWAE's one forward, and
    every printed number finite."""
    from vihds_tpu_torch.tools import refine_demo as demo

    with tempfile.TemporaryDirectory() as directory:
        spec = write_spec(SPEC_UNMERGED, directory, solver=TRAIN_SOLVER,
                          eval_solver=TRAIN_SOLVER)
        shown, wall, launches, lines = run_tool(lambda: demo.main([ckpt_dir, spec],
                                                                  device=device))
    for line in lines:
        print("  " + line)
    smc = sampler_launches("smc_refine", dict(n_particles=64, n_temps=demo.N_TEMPS,
                                              n_moves=demo.N_MOVES))
    hmc = sampler_launches("hmc_refine", dict(n_chains=64, n_steps=demo.N_STEPS))
    want = (1 + smc[0] + hmc[0], smc[1] + hmc[1])
    print("phase 20j: refine_demo on phase 14's checkpoint (%d series, K = 64), %.1f s"
          % (demo.MAX_SERIES, wall))
    check_tool_launches("20j", "refine_demo", launches, want)
    if not all(math.isfinite(v) for v in shown.values()):
        fail("phase 20j: refine_demo printed %s" % shown)
    return dict(wall=wall, launches=launches, printed=shown)


def phase_ar_mu(device):
    """Phase 20k: ``tools.ar_mu_ground_truth run`` on ``dr_constant_one``
    (36 training series, 16 chains: R = 576) through the per-series route
    and the pooled Gibbs route (``ARMU_ROUTES``) at ``TOOLS_DEPTH``, each
    run's ``dr`` launches against its training's and ``sampler_launches``;
    then ``report`` over the two npz beside a copy of the recorded
    ``reports/ar_mu_ground_truth_r5`` seeds: each npz has the recorded
    keys (the pooled route's, those of the JAX tool's pooled route: all but
    ``*_series_*``), the report a row for each seed."""
    import glob

    import numpy as np

    from vihds_tpu_torch.tools import ar_mu_ground_truth as am

    depth = TOOLS_DEPTH["20k"]
    recorded = sorted(glob.glob(os.path.join(HERE, "reports", "ar_mu_ground_truth_r5",
                                             "seed*.npz")))
    with np.load(recorded[0]) as z:
        keys = set(z.files)
    out = {}
    saved = am.SPEC
    with tempfile.TemporaryDirectory() as directory:
        am.SPEC = write_spec(SPEC_ONE, directory, solver=TRAIN_SOLVER)
        outdir = os.path.join(directory, "out")
        os.environ["VIHDS_ARMU_EPOCHS"] = str(depth["epochs"])
        try:
            for route, seed in ARMU_ROUTES:
                os.environ["VIHDS_ARMU_SAMPLER"] = route
                path, wall, launches, lines = run_tool(lambda: am.main(
                    ["run", str(seed), outdir, str(depth["n_steps"])], device=device))
                fwd, bwd = tool_training_launches(am.SPEC, seed, depth["epochs"])
                name, kw = {"perseries": ("hmc_refine", dict(
                                n_chains=16, n_steps=depth["n_steps"])),
                            "gibbs": ("gibbs_refine_pooled", dict(
                                n_chains=16, n_sweeps=depth["n_steps"], n_leapfrog=10))}[route]
                s_fwd, s_bwd = sampler_launches(name, kw)
                with np.load(path) as z:
                    got = set(z.files)
                    readings = {k: float(z[k]) for k in ("best_val_elbo", "accept", "aR_q_mu",
                                                           "aR_hmc_mean", "aR_rhat")}
                want_keys = keys if route == "perseries" else {k for k in keys
                                                               if "_series_" not in k}
                print("phase 20k: ar_mu_ground_truth run %d (%s), %d epochs, %d steps: %.1f s; "
                      "%s; the recorded npz's keys present: %s"
                      % (seed, route, depth["epochs"], depth["n_steps"], wall,
                         json.dumps(readings), want_keys <= got))
                check_tool_launches("20k", route, launches, (fwd + s_fwd, bwd + s_bwd))
                if not want_keys <= got or not all(math.isfinite(v) for v in readings.values()):
                    fail("phase 20k: %s's npz lacks %s or reads %s"
                         % (route, sorted(want_keys - got), readings))
                out[route] = dict(wall=wall, launches=launches, readings=readings)
        finally:
            am.SPEC = saved
            for k in ("VIHDS_ARMU_EPOCHS", "VIHDS_ARMU_SAMPLER"):
                os.environ.pop(k, None)
        for path in recorded:
            shutil.copy(path, outdir)
        _, _, _, lines = run_tool(lambda: am.main(["report", outdir]))
        with open(os.path.join(outdir, "REPORT.md")) as f:
            report = f.read()
    rows = [line for line in report.splitlines() if line.startswith("| ")
            and line.split(" | ")[0][2:].isdigit()]
    seeds = sorted({int(line.split(" | ")[0][2:]) for line in rows})
    print("phase 20k: report over the port's seeds %s beside the recorded seeds 0-%d: %d rows "
          "for seeds %s" % ([s for _, s in ARMU_ROUTES], len(recorded) - 1, len(rows), seeds))
    if seeds != list(range(len(recorded))) + [s for _, s in ARMU_ROUTES]:
        fail("phase 20k: the report's rows cover seeds %s" % seeds)
    return out


def phase_icml_mechanism(device):
    """Phase 20l: ``tools.icml_site_mechanism`` on ``dr_constant_icml`` (234
    training series): ``ridge`` (16 chains, 10 leapfrog steps, ``mass_from_q``
    and ``adapt_mass``: R = 3,744) and ``drift`` at ``TOOLS_DEPTH``, each
    one's ``dr`` launches against its trainings' and ``sampler_launches``;
    the correlation matrix finite with a unit diagonal, the drift rows
    finite."""
    import numpy as np

    from vihds_tpu_torch.tools import icml_site_mechanism as im

    depth = TOOLS_DEPTH["20l"]
    out = {}
    saved = im.SPEC
    with tempfile.TemporaryDirectory() as directory:
        im.SPEC = write_spec(SPEC, directory, solver=TRAIN_SOLVER)
        outdir = os.path.join(directory, "out")
        try:
            path, wall, launches, lines = run_tool(lambda: im.ridge(
                0, outdir, device, epochs=depth["epochs"], n_steps=depth["n_steps"]))
            fwd, bwd = tool_training_launches(im.SPEC, 0, depth["epochs"])
            s_fwd, s_bwd = sampler_launches("hmc_refine", dict(n_chains=16,
                                                               n_steps=depth["n_steps"],
                                                               n_leapfrog=10))
            with np.load(path) as z:
                corr, accept = z["mean_corr"], float(z["accept"])
            ok = bool(np.isfinite(corr).all() and np.allclose(np.diagonal(corr), 1.0, atol=1e-5))
            print("phase 20l: icml_site_mechanism ridge, %d epochs, %d steps: %.1f s; accept "
                  "%.3f; corr(aYFP, e81) %.3f, corr(aYFP, KGR_81) %.3f; finite, unit diagonal: %s"
                  % (depth["epochs"], depth["n_steps"], wall, accept, corr[0, 1], corr[0, 2], ok))
            check_tool_launches("20l", "ridge", launches, (fwd + s_fwd, bwd + s_bwd))
            if not ok:
                fail("phase 20l: ridge's correlations %s" % corr)
            out["ridge"] = dict(wall=wall, launches=launches, accept=accept)
            path, wall, launches, lines = run_tool(lambda: im.drift(0, outdir, depth["grid"],
                                                                    device))
            want = [tool_training_launches(im.SPEC, 0, e) for e in depth["grid"]]
            with np.load(path) as z:
                rows = {k: z[k].tolist() for k in z.files}
            ok = all(np.isfinite(v).all() for v in rows.values())
            print("phase 20l: icml_site_mechanism drift over epochs %s: %.1f s; %s; finite: %s"
                  % (depth["grid"], wall, json.dumps(rows), ok))
            check_tool_launches("20l", "drift", launches, tuple(map(sum, zip(*want))))
            if not ok:
                fail("phase 20l: drift's rows %s" % rows)
            out["drift"] = dict(wall=wall, launches=launches)
        finally:
            im.SPEC = saved
    return out


def phase_posterior_parity(device):
    """Phase 20m: ``tools.posterior_parity ours`` on ``dr_constant_one`` for
    2 seeds at ``TOOLS_DEPTH`` (K = 200), each run's ``dr`` launches against
    its training's; then ``compare --against`` the recorded battery
    ``reports/posterior_parity_ctrl_unit`` (its ``ours_seed*``, the JAX
    package's): the port's q-site names and shapes the recorded ones,
    REPORT.md written to the port's directory and the recorded directory
    untouched; then ``clip_activity`` on the port's directory, a finite row
    per seed."""
    import hashlib

    import numpy as np

    from vihds_tpu_torch.tools import clip_activity, posterior_parity as pp

    def hashes():
        return {n: hashlib.sha256(open(os.path.join(PARITY_RECORDED, n), "rb").read()).hexdigest()
                for n in sorted(os.listdir(PARITY_RECORDED))}

    depth = TOOLS_DEPTH["20m"]
    before = hashes()
    with np.load(os.path.join(PARITY_RECORDED, "ours_seed0.npz"), allow_pickle=True) as z:
        names, shapes = list(z["q_names"]), [np.shape(v) for v in z["q_values"]]
    runs = {}
    with tempfile.TemporaryDirectory() as directory:
        spec = write_spec(SPEC_ONE, directory, solver=TRAIN_SOLVER)
        outdir = os.path.join(directory, "out")
        for seed in depth["seeds"]:
            path, wall, launches, lines = run_tool(lambda: pp.main(
                ["ours", str(seed), str(depth["epochs"]), outdir, spec], device=device))
            with np.load(path, allow_pickle=True) as z:
                same = (list(z["q_names"]) == names
                        and [np.shape(v) for v in z["q_values"]] == shapes)
                elbo = float(z["elbo"])
            print("phase 20m: posterior_parity ours %d, %d epochs: %.1f s; %s; best-val ELBO "
                  "%.2f; q-site names and shapes the recorded ones: %s"
                  % (seed, depth["epochs"], wall, lines[-1], elbo, same))
            check_tool_launches("20m", "ours %d" % seed, launches,
                                tool_training_launches(spec, seed, depth["epochs"]))
            if not same or os.path.dirname(path) != outdir:
                fail("phase 20m: seed %d wrote %s" % (seed, path))
            runs[seed] = dict(wall=wall, launches=launches, elbo=elbo)
        report, wall, _, _ = run_tool(lambda: pp.main(
            ["compare", outdir, "--against", PARITY_RECORDED, "--against_tag", "ours"]))
        written = os.path.exists(os.path.join(outdir, "REPORT.md"))
        summary = [line for line in report.splitlines() if line.startswith("**")]
        print("phase 20m: compare against the recorded JAX side (12 seeds): %s; REPORT.md "
              "written to the port's directory: %s; the recorded directory untouched: %s"
              % (summary, written, hashes() == before))
        if not written or hashes() != before or len(summary) != 2:
            fail("phase 20m: compare wrote %s" % os.listdir(outdir))
        _, _, _, lines = run_tool(lambda: clip_activity.main([outdir]))
    table = [line for line in lines if line.startswith("| ours_seed")]
    print("phase 20m: clip_activity on the port's runs: %s" % table)
    finite = all(math.isfinite(float(line.split(" | ")[1])) for line in table)
    if len(table) != len(depth["seeds"]) or not finite:
        fail("phase 20m: clip_activity printed %s" % lines)
    return dict(runs=runs, compare=summary)


def phase_xval_plotting(figures_dir):
    """Phase 20n: ``tools.xval_plotting`` on phase 18b's artifacts.  Where
    matplotlib, seaborn or tensorboard does not import (the card's
    machine), it stops with ``run_xval --figures``'s line naming the
    first, writing nothing; where they do, it writes the six figure
    families as png and pdf."""
    from vihds_tpu_torch import utils
    from vihds_tpu_torch.tools import xval_plotting

    missing = utils.missing_packages(utils.FIGURE_PACKAGES)
    before = sorted(os.listdir(figures_dir))
    stopped = None
    t0 = time.perf_counter()
    try:
        run_tool(lambda: xval_plotting.main([figures_dir, SPEC]), kinds=())
    except SystemExit as e:
        stopped = str(e)
    wall = time.perf_counter() - t0
    after = sorted(os.listdir(figures_dir))
    families = sorted({n[:-4] for n in set(after) - set(before) if n.endswith(".png")})
    print("phase 20n: xval_plotting on phase 18b's artifacts, %.1f s: the figures' packages "
          "missing: %s; stopped: %r; figure families written: %s"
          % (wall, missing or "none", stopped, families))
    if missing:
        want = "--figures needs the %s package, which is not installed" % missing[0]
        if stopped != want or after != before:
            fail("phase 20n: without %s xval_plotting said %r and wrote %s"
                 % (missing, stopped, sorted(set(after) - set(before))))
    else:
        prefixes = ("xval_fit", "xval_treatments", "xval_species", "xval_global_parameters",
                    "xval_variable_parameters", "xval_summary_", "xval_individual_")
        if stopped or not all(any(f.startswith(p) for f in families) for p in prefixes):
            fail("phase 20n: xval_plotting wrote %s" % families)
    return dict(wall=wall, missing=missing, families=families)


class PhaseWalls:
    """The wall of each group of phases: ``mark(label)`` closes the group
    that began at the last mark (or at creation)."""

    def __init__(self):
        self.seconds = {}
        self.last = time.perf_counter()

    def mark(self, label):
        now = time.perf_counter()
        self.seconds[label] = round(now - self.last, 1)
        self.last = now


def distributed_launches(distributed, kernel):
    """{layout: {rank: launches of ``kernel``}} of phase 5g."""
    return {label: {str(r): got["launches"][kernel] for r, got in run["ranks"].items()}
            for label, run in distributed["layouts"].items()}


def mesh_launches(refine_mesh, kernel):
    """{rank: {path: launches of ``kernel``}} of phase 20i's two ranks."""
    return {label: {path: r["launches"][kernel] for path, r in got.items()}
            for label, got in refine_mesh["readings"].items() if label != "one"}


def tools_launches(tools, kernel):
    """{phase: launches of ``kernel``, or {run: launches}} of phases
    20j-20m."""
    return {"20j": tools["20j"]["launches"][kernel],
            "20k": {route: r["launches"][kernel] for route, r in tools["20k"].items()},
            "20l": {mode: r["launches"][kernel] for mode, r in tools["20l"].items()},
            "20m": {str(seed): r["launches"][kernel]
                    for seed, r in tools["20m"]["runs"].items()}}


def refine_launches(paths, i):
    """{phase: {stage or sampler: launches}} of one direction (0 forward, 1
    backward) from the HMC paths' ``check_sampler`` readings."""
    return {phase: {stage: r["launches"][i] for stage, r in stages.items()}
            for phase, stages in paths.items()}


def kernel_row(kind, direction, rows, launches, **extra):
    """One entry of the ``kernels`` line: the midpoint readings of phase 3
    (the forward's at the serving chunk), the launches on the main path."""
    row = rows["midpoint"]
    first_line = {("fwd", False): 340, ("bwd", False): 364, ("fwd", True): 474, ("bwd", True): 500}
    from vihds_tpu_torch.ops import fused_ode

    if kind == "blackbox":
        replaces = "vihds_tpu/ops/pallas_blackbox.py:%d" % {"fwd": 88, "bwd": 108}[direction]
    else:
        replaces = "vihds_tpu/ops/pallas_ode.py:%d" % first_line[(direction,
                                                                 fused_ode.KINDS[kind].prec)]
    return dict(
        name="%s_%s" % (kind, direction),
        route="cuda",
        source="vihds_tpu_torch/csrc/%s_%s.cu" % (kind, direction),
        replaces=replaces,
        kind=kind,
        method="midpoint",
        launches=launches,
        max_abs_err=row["max_abs_err"],
        ms=row["ms"],
        plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"],
        bound_by=row["bound_by"],
        # no single PyTorch call integrates these ODEs or computes their VJPs
        library_ms=None,
        **({"block": row["block"]} if "block" in row else {}),
        **extra,
    )


def depth_statement():
    """Each phase whose depth is cut to keep the script within its time
    limit: {phase: {setting: [this run's, the default]}}, read from
    ``STUDY_DEPTH``, ``RECORDED_STUDIES``, ``OTHER_SAMPLERS``,
    ``TOOLS_DEPTH`` and ``ZOO_FIRST_FILE`` against the study's, the
    samplers', the tools' and the specs' own defaults."""
    import inspect

    import yaml

    from vihds_tpu_torch import recovery_study as rs
    from vihds_tpu_torch import refine

    study = rs.parse([])
    keys = ("epochs", "refine_steps", "pooled_steps")
    cut = rs.parse(STUDY_DEPTH)
    out = {"20e": {k: [getattr(cut, k), getattr(study, k)] for k in keys}}
    for phase, _, _, _, epochs, steps in RECORDED_STUDIES:
        out[phase] = dict(zip(keys, ([v, getattr(study, k)]
                                     for k, v in zip(keys, (epochs,) + tuple(steps)))))
    out["20h"] = {}
    for name, _, _, kw in OTHER_SAMPLERS:
        params = inspect.signature(getattr(refine, name)).parameters
        out["20h"][name] = {k: [v, params[k].default] for k, v in kw.items()
                            if k.startswith("n_")}
    from vihds_tpu_torch.tools import ar_mu_ground_truth as am
    from vihds_tpu_torch.tools import icml_site_mechanism as im
    from vihds_tpu_torch.tools import posterior_parity as pp

    armu, icml = TOOLS_DEPTH["20k"], TOOLS_DEPTH["20l"]
    ridge = inspect.signature(im.ridge).parameters
    out["20k"] = {"epochs": [armu["epochs"], am.EPOCHS],
                  "n_steps": [armu["n_steps"], inspect.signature(am.run).parameters[
                      "n_steps"].default]}
    out["20l"] = {"ridge epochs": [icml["epochs"], ridge["epochs"].default],
                  "ridge n_steps": [icml["n_steps"], ridge["n_steps"].default],
                  "drift grid": [icml["grid"], list(im.DRIFT_GRID)]}
    out["20m"] = {"epochs": [TOOLS_DEPTH["20m"]["epochs"], pp.DEFAULT_EPOCHS]}
    out["16"] = {}
    for name in ZOO_FIRST_FILE:
        with open(os.path.join(HERE, "specs", name)) as f:
            out["16"][name] = {"files": [1, len(yaml.safe_load(f)["data"]["files"])]}
    return out


def main():
    if not os.path.isdir(os.path.join(HERE, "vihds_tpu_torch")):
        print("chip_smoke: the vihds_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from vihds_tpu_torch.models.degrader_constant import Degrader_Constant
    from vihds_tpu_torch.models.relay_constant import Relay_Constant
    from vihds_tpu_torch.ops import fused_ode
    from vihds_tpu_torch.utils import resolve_device

    device = resolve_device("cuda")
    t_start = time.perf_counter()
    clock = PhaseWalls()
    phase_card()
    phase_build()
    clock.mark("1-2")
    measured = {kind: phase_kind_kernels(device, kind, SEED + 10 * i + 1)
                for i, kind in enumerate(fused_ode.KINDS)}
    measured["blackbox"] = phase_blackbox_kernels(device, SEED + 101)
    fold_axis = phase_fold_kernels(device)
    clock.mark("3-3f")

    serving, training = {}, {}
    serving["dr"], walls, served = serve(device, SPEC, REQUESTS, "4", "dr_fwd")
    phase_route_check(device, served)
    phase_profile(device, walls[1])
    training["dr"], step_ms_5, train5 = train(device, SPEC, "5", "dr_fwd", "dr_bwd")
    phase_route_check_training(device)
    phase_profile_training(device)
    vmap = phase_vmap_xval(device, phase_call_run_xval(device))
    vmap_launches = dict(vmap["launches"])
    for launches in phase_vmap_weighted(device).values():
        vmap_launches.update(launches)
    distributed = phase_distributed(train5, training["dr"])
    del train5
    clock.mark("4-5g")

    serving["dr_prec"] = serve(device, SPEC_PREC, REQUESTS, "6", "dr_prec_fwd")[0]
    # v2's version lives in the host-side fracLuxR / fracLasR: the same kernel
    serve(device, SPEC_PREC_V2, REQUESTS[:1], "6", "dr_prec_fwd")
    training["dr_prec"] = train_nets(device, SPEC_PREC, "7", "dr_prec")[0]
    phase_route_check_training(device, SPEC_PREC, "7b")
    phase_profile_training(device, SPEC_PREC, "7c")

    for family, spec, files, cf, cls, p in (
            ("relay", SPEC_RELAY, RELAY_REQUESTS, COUNTERFACTUAL, Relay_Constant, 8),
            ("degrader", SPEC_DEGRADER, DEGRADER_REQUESTS, DEGRADER_COUNTERFACTUAL,
             Degrader_Constant, 10)):
        kind = family + "_prec"
        serving[kind], _, served = serve(device, spec, files, str(p), kind + "_fwd", cf)
        phase_route_check(device, served, spec, "%db" % p)
        training[family] = phase_plain_kind(device, spec, cls, "%dd" % p)
        training[kind] = train_nets(device, spec, str(p + 1), kind)[0]
        phase_route_check_training(device, spec, "%db" % (p + 1))
        phase_profile_training(device, spec, "%dc" % (p + 1))

    serving["blackbox"], walls, served = serve(device, SPEC_BB, REQUESTS, "12", "blackbox_fwd")
    phase_route_check(device, served, SPEC_BB, "12b")
    phase_profile(device, walls[1], SPEC_BB, "12c")
    training["blackbox"] = train_nets(device, SPEC_BB, "13", "blackbox",
                                      nets=("states", "precisions"))[0]
    phase_route_check_training(device, SPEC_BB, "13b")
    phase_profile_training(device, SPEC_BB, "13c")
    clock.mark("6-13c")

    # phase 14's checkpoint, served again over the ranks in phase 20i
    kept = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as results_dir:
        unmerged, um_training = phase_unmerged_training(device, results_dir)
        phase_route_check_training(device, SPEC_UNMERGED, "14b")
        t100 = phase_unmerged_kernels(device)
        unmerged["dr_fwd_serving"] = phase_serve_checkpoint(device, um_training, results_dir)
        ckpt_14 = shutil.copytree(um_training.ckpt_dir, os.path.join(kept.name, "checkpoints"))
        phase_zoo(device, results_dir)
    phase_growthrate_route(device)
    clock.mark("14-16b")

    dreg = phase_dreg_training(device, step_ms_5)
    dreg["per_step"] = phase_dreg_route_check(device)
    dreg_ops = phase_dreg_operands(device)
    phase_profile_dir(device)
    # phase 18b's artifacts, read again by phase 20n
    figures_dir = os.path.join(kept.name, "figures")
    phase_figures(device, keep=figures_dir)
    clock.mark("17-18b")

    adaptive = phase_adaptive(device)
    adaptive["check"] = phase_adjoint_check(device)
    adaptive["vmap"] = phase_vmap_adaptive(device)
    clock.mark("19-19d")
    graph = phase_graph(device)
    graph["jobs_wall"] = phase_graph_jobs(device)["wall"]
    clock.mark("20-20b")
    simulated = phase_simulate(device)
    recorded = phase_recorded_truths(device)
    clock.mark("20c-20d")
    recovery = phase_recovery(device)
    clock.mark("20e")
    source = recovery.pop("source")
    recorded_studies = {phase: phase_recorded_study(device, phase, report, spec, kind, epochs,
                                                    steps)
                        for phase, report, spec, kind, epochs, steps in RECORDED_STUDIES}
    recorded_study = recorded_studies["20f"]
    clock.mark("20f-20g")
    others = phase_other_samplers(device, source)
    del source
    clock.mark("20h")
    refine_mesh = phase_refine_mesh(device, ckpt_14)
    clock.mark("20i")
    tools = {"20j": phase_refine_demo(device, ckpt_14), "20k": phase_ar_mu(device),
             "20l": phase_icml_mechanism(device), "20m": phase_posterior_parity(device),
             "20n": phase_xval_plotting(figures_dir)}
    kept.cleanup()
    clock.mark("20j-20n")
    # the HMC paths' launches and backward readings per kind (phases 20e-20h)
    refine_paths = {"dr": {"20e": recovery["stages"], "20f": recorded_study["stages"],
                           "20h": others["samplers"]},
                    "dr_prec": {"20g": recorded_studies["20g"]["stages"]}}

    kernels = []
    for kind, (fwd_rows, bwd_rows, train_fwd_rows) in measured.items():
        # the launches: the training path's (for the plain relay / degrader
        # kinds, phase 8d's / 10d's path); the serving path's beside them
        launches = training[kind]
        extra = {"launches_serving": serving[kind]} if kind in serving else {}
        # the dr kernels on phases 14-15's merge: false path, timed at T=100
        um = kind == "dr"
        if kind == "dr_prec":  # phase 20's dr node
            extra["launches_graph"] = graph["launches"]["dr_prec_fwd"]
        # phases 5e-5f: launches on the --vmap_folds path (None: no such
        # phase runs the kernel); 3f: the fold launch's time at 4 x 7,200 rows
        extra["launches_vmap"] = vmap_launches.get(kind + "_fwd")
        if kind in fold_axis:
            extra["vmap_fold"] = {k: fold_axis[kind]["midpoint"][k]
                                  for k in ("fwd_ms", "fwd_separate_ms")}
        if kind == "dr":  # phases 5g and 20i: each rank's launches; 20j-20m
            extra["launches_distributed"] = distributed_launches(distributed, "dr_fwd")
            extra["launches_refine_mesh"] = mesh_launches(refine_mesh, "dr_fwd")
            extra["launches_tools"] = tools_launches(tools, "dr_fwd")
        if kind in simulated:  # phases 20c-20g: the simulator and the recovery study
            extra["launches_simulate"] = simulated[kind]["launches"][kind + "_fwd"]
            extra["launches_recorded_truth"] = recorded[kind + "_fwd"]["launches"]
            extra["launches_recovery"] = recovery["launches"].get(kind + "_fwd")
            extra["launches_recorded_study"] = next(
                r["launches"][kind + "_fwd"] for r in recorded_studies.values()
                if kind + "_fwd" in r["launches"])
        if kind in refine_paths:  # phases 20e-20h: each HMC path's launches
            extra["launches_refine"] = refine_launches(refine_paths[kind], 0)
        kernels.append(kernel_row(
            kind, "fwd", fwd_rows, launches[kind + "_fwd"],
            train_shape={k: train_fwd_rows["midpoint"][k]
                         for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            **extra, **({"launches_unmerged": {"training": unmerged["dr_fwd"],
                                               "serving": unmerged["dr_fwd_serving"]},
                         "unmerged_t100": t100["fwd"]} if um else {})))
        # the DReG step's pulls (phases 17-17c): launches in one step (and in
        # phase 17's training for dr), the time and cotangent of the DReG pull
        # beside the standard pull's on the same step
        extra = {}
        if kind in dreg_ops:
            ops = dreg_ops[kind]
            extra = dict(launches_dreg=dreg["per_step"][kind + "_bwd"],
                         dreg_ms=ops["dreg"]["ms"],
                         dreg_subnormal_share=ops["dreg"]["subnormal_share"],
                         dreg_zero_share=ops["dreg"]["zero_share"],
                         dreg_standard_pull_ms=ops["standard"]["ms"],
                         dreg_standard_pull_subnormal_share=ops["standard"]["subnormal_share"])
            if kind == "dr":
                extra["launches_dreg_training"] = dreg["launches"]["dr_bwd"]
        if kind == "dr_prec":
            extra["launches_graph"] = graph["launches"]["dr_prec_bwd"]
        extra["launches_vmap"] = vmap_launches.get(kind + "_bwd")
        if kind in fold_axis:
            extra["vmap_fold"] = {k: fold_axis[kind]["midpoint"][k]
                                  for k in ("bwd_ms", "bwd_separate_ms")}
        if kind == "dr":
            extra["launches_distributed"] = distributed_launches(distributed, "dr_bwd")
            extra["launches_refine_mesh"] = mesh_launches(refine_mesh, "dr_bwd")
            extra["launches_tools"] = tools_launches(tools, "dr_bwd")
        if kind in simulated:
            extra["launches_simulate"] = simulated[kind]["launches"][kind + "_bwd"]
            extra["launches_recovery"] = recovery["launches"].get(kind + "_bwd")
            extra["launches_recorded_study"] = next(
                r["launches"][kind + "_bwd"] for r in recorded_studies.values()
                if kind + "_bwd" in r["launches"])
        if kind in refine_paths:  # the backward on each HMC path's dense operands
            extra["launches_refine"] = refine_launches(refine_paths[kind], 1)
            extra["refine_operands"] = {
                path: {stage: r["bwd"] for stage, r in stages.items() if "bwd" in r}
                for path, stages in refine_paths[kind].items()}
        kernels.append(kernel_row(
            kind, "bwd", bwd_rows, launches[kind + "_bwd"],
            **{key: bwd_rows["midpoint"][key] for key in ("step_ms", "step_zero_share")},
            **({"launches_unmerged": {"training": unmerged["dr_bwd"]},
                "unmerged_t100": t100["bwd"]} if um else {}), **extra))
    print("phase 21: total %.1f s" % (time.perf_counter() - t_start))
    print("phase 21: walls (s) " + json.dumps(clock.seconds))
    print("phase 21: depth, [this run's, the default] " + json.dumps(depth_statement()))
    print("phase 21: paths " + json.dumps({"adaptive": adaptive, "refine_mesh": refine_mesh,
                                           "graph": graph,
                                           "vmap_folds": vmap, "distributed": distributed,
                                           "simulate": simulated,
                                           "recorded_truths": recorded, "recovery": recovery,
                                           "recorded_studies": recorded_studies,
                                           "other_samplers": others, "tools": tools}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
