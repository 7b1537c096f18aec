#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero (it also does so, printing no result, without CUDA):

  0. device: the card, ``nvidia-smi`` name and power limit; TF32 off.
  1. build: nvcc builds ``diffnet_tpu_torch/csrc/poisson2d.cu``,
     ``stencil2d.cu``, ``poisson3d.cu``, ``stencil3d.cu`` and ``ns2d.cu``
     (sm_90a, one process each, all started together) into one library.
  2. kernels: K1 (stiffness action and masked residual), K2 (resmin loss
     and gradient) and K3 (Ritz energy) against their plain torch versions
     at 33^2 (anisotropic h), 40^2, 1x513^2 (slice D2's fine level),
     512^2 x 32 and at shapes on their tile edges (1x2^2, 3x129x257,
     1x100x77, 1x40x65: widths no multiple of the 64 columns of K1's and
     K3's tiles or K2's 61); K1 also at 24x49; K2 and K3 at every tile
     height at 1x513^2 and 512^2 x 32. K1
     and K3 also take bf16 fields: both against their bf16 plain versions
     at every K1 shape, within 8e-3 x max(1, |plain|) (each rounds once
     from float32). K4 (the assembled 9-point stencil apply)
     against its plain version at 2x33^2, 1x40x56, 3x17x129, slice D's
     levels 1x513^2, 1x257^2, 1x129^2, 1x65^2, and 32x512^2, and slice
     O's halo'd row blocks of the split V-cycle (1x130x513, 1x129x513,
     1x66x257, 1x65x257, 1x34x129, 1x33x129, 1x18x65, 1x17x65; the middle
     ones timed), each with per-sample and batch-1 C.
     The time of each at 512^2 x 32 (K1 in float32 and bf16) beside its
     plain version's and its bound (CUDA events around 10 back-to-back
     calls queued behind a spin kernel, median of 20 runs; see
     ``cuda_ms``).
     K5 (the trilinear stiffness action and its masked residual) at 2x9^3
     (anisotropic h), 2x17^3, 2x20x17x17, 1x129^3 (slice F's fine level),
     4x64^3, 1x128^3, slice I's 1x32^3 and its tile edges 1x9x45x45,
     2x3x17x17 and 1x65^3,
     every strip length at 1x129^3 and 1x9x45x45, timed at 4x64^3 and
     1x128^3; K4-3D (the 27-point apply)
     at 2x9^3, 1x10x12x14, slice F's levels 1x129^3, 65^3, 33^3, 17^3 and
     1x128^3, per-sample and batch-1 C, timed at 1x128^3.
     K6 (the fused VMS Navier-Stokes residual) at 2x33^2 (anisotropic h),
     2x40^2 with forcing, 2x65^2, 1x2^2 and 1x97^2 (its tile edges),
     1x129^2 (slice G1's grid), 8x256^2 and 8x512^2, visco 0.01, each
     residual within 2e-5 x max(1, max |plain|) (the JAX package's
     kernel-vs-XLA tolerance), timed at the last two; through its row-block
     entry (the split route: ny != nx, the square grid's spacing) at the
     halo'd blocks 1x33x129, 1x34x129, 1x35x129, 8x66x256, 2x9x32 (with
     forcing) and 1x2x65, each timed; the global entry must refuse
     ny != nx.
  3. gradients: the K1 du/dnu, K3 du, K2 du and K4 dC/du VJPs against
     autograd through the plain versions, at 65^2; the K5 du/dnu and K4-3D
     dC/du VJPs at 17^3; the K6 VJP and its JVP (``torch.func.jvp``) at 33^2.
  4-15. the main paths (launch counts set to 0 first, read after each):
     A. the README quick start through ``Trainer.fit``, 64^2 MMS resmin
        with LBFGS; rel L2 vs the exact solution must be <= 2.6e-4 (the JAX
        package gives 2.046e-4);
     B. 512^2 x 32 resmin with the single-launch loss+grad kernel, Adam,
        10 steps from a seeded random field; the loss must fall, K2 must
        launch once a step, and the first loss must match the unfused path;
     C. 512^2 x 32 energy with the fused energy kernel, Adam, 10 steps;
     D. the linear-solver path: bench.py's 513^2 variable-nu (54x
        contrast) Poisson problem, solved by 14 iterations of CG
        preconditioned by a geometric-multigrid V-cycle
        (``multigrid_preconditioner``, n_coarse=33, inputs restricted from
        the fine level), in three variants: D1 the plain stencil matvec,
        D2 the fine level and outer matvec through K1 (``fine_matvec``),
        D3 every assembled level and the outer matvec through K4
        (``stencil_kernel="cuda"``). Each relative residual, under the
        variant's own operator and under D1's element-path operator (which
        runs no kernel), must be <= 1.8e-5 (twice the JAX package's
        8.92e-6); D2 must launch K1, D3 K4. One solve of each variant runs
        under ``torch.profiler`` for its device operations, busy time and
        idle share;
     E. 3D training through ``Trainer.fit`` with ``fused_kernels=True``
        (K5): E1 examples/poisson_3d.py's 17^3 MMS resmin run (LBFGS, 60
        epochs x 10 iterations), rel L2 <= 1.3x the JAX package's; E2 10
        Adam steps at 64^3 x 4 from a seeded random field, the loss must
        fall, the first loss match the unfused path and K5 launch at least
        twice a step;
     F. the 3D linear-solver path: a 129^3 variable-nu (55x contrast)
        MG-CG solve (levels 129-65-33-17-9, 14 iterations) in three
        variants: F1 the plain stencil, F2 K5 on the fine level and outer
        matvec, F3 K4-3D on every assembled level and the outer matvec;
        each relative residual, under its own operator and under F1's
        element-path operator, <= 2x the JAX package's; F2 must launch K5,
        F3 K4-3D; one profiled solve of each.
     G. the flow path, through K6: G1 the lid-driven cavity at Re 100 on
        129^2 nodes (the reference's 128 x 128 elements) solved from rest
        by ``ns_newton_solve`` (15 Newton iterations, the defaults),
        ``fused_kernels=True``, held to the JAX package's figures on the
        same problem (scripts/torch_port_reference_flow.py): final |F| <=
        max(1e-6, 2x JAX's), accepted steps <= JAX's + 2, the midline
        extrema of u and v and the pressure on y = 0.5 within 2e-3, the lid
        within 1e-5; the solve's time is the entry point's run less the
        preconditioner setup, timed apart; one Newton iteration profiled;
        without the kernel one Newton step through the entry point, its
        |F| within 1e-5 relative of the fused solve's after its first
        step (K6 against its plain version at 1 x 129^2 is phase 2's).
        G2 examples/ns_ldc.py's training
        configuration at 64^2 (three-field DirectField from zeros, squared
        norm, LBFGS x 10) through ``Trainer.fit``: the loss below 0.05x its
        first value, the first loss within 1e-5 of the unfused module's, K6
        launched at least once an evaluation. G3 10 Adam steps at 8 x 256^2
        from seeded random fields: the loss falls, K6 launches once a step,
        the first loss matches the unfused path.
     H. the IBN flagship (reference IBN_2D.py) at its full width: 1,024
        synthetic ellipse clouds of 120 points, chi from the winding
        number on 32^2 nodes, ``AE(dims=8, n_downsample=2)``, the
        gpw-weighted Ritz energy, Adam 3e-4 with the rate divided by 10
        after epochs 10, 15 and 30, batches of 64, 40 epochs from the JAX
        reference's initial weights (``seeded_params``) through
        ``Trainer.fit``: steps/s through fit (each epoch after the first),
        again through a loader with ``prefetch=2`` (a second fit of 11
        epochs) and resident (three runs of 20 steps), one profiled
        resident step, the first and last epoch loss, 8 held-out clouds
        scored against the direct Krylov solve of their immersed problems
        (rel L2 on the free nodes, held to 1.25x the JAX package's from
        scripts/torch_port_reference_ibn.py, and the energy gap), and an
        export, save and load of the trained AE at batch 1 and 64 (outputs
        within 1e-6 of the module's, CUDA-event latencies). No kernel of
        the table runs on this path: the JAX package computes it with XLA.
        H2. the point-cloud inputs on slice H's clouds at batches of 512, 10
        epochs each through ``Trainer.fit``: ``DGCNN2D(k=20,
        lowest_size=16)`` on the points (``network_input='cloud'``) and
        ``ImmDiffLargeNormals`` on points and normals
        (``'cloud_normals'``); losses finite and falling, steps/s through
        fit and resident, one profiled resident step, and DGCNN2D's
        neighbour searches and edge convs timed against its forward.
     I. the 3D IBN (reference IBN_3D.py) at the JAX package's UNet3D
        width: 64 synthetic bar-lattice topologies on 32^3 nodes,
        ``UNet3D(base_filters=16)`` on (domain, chi, bc2), from the JAX
        reference's initial weights (``interop.seeded_params``), the
        gpw-weighted Ritz energy, batches of 8, Adam 1e-3, 36 epochs
        through ``Trainer.fit``: steps/s through fit and resident, one
        profiled resident step, the peak memory; 4 held-out topologies
        each scored against its direct CG solve on a ``Poisson3D`` resmin
        module, every matvec through K5 (rel L2 on the free nodes held to
        1.25x the JAX package's from scripts/torch_port_reference_ibn3d.py,
        the energy gap; each solve must stop at its tolerance before
        maxiter); a surface-nets mesh of the trained network's field on
        a held-out topology, against the mesh of the CPU forward of the
        same weights.
     J. the parametric KL-sum UQ path (examples/klsum_uq.py at
        BASELINE.md's 64^2 KL-sum configuration): 4,096 Sobol KL
        coefficient samples made into diffusivity fields by the host
        library (``KLSumStochastic``), ``GoodNetwork(filters=16)`` on
        (nu, bc1, bc2) from the JAX reference's initial weights, the Ritz
        energy with ``fused_kernels=True`` (K3 forward, K1 in its VJP),
        batches of 32, Adam 3e-4, 3 epochs through ``Trainer.fit`` with
        checkpoints; ``query_statistical`` over 256 query samples; the
        first 64 solved directly by CG through K1; the held-out rel L2
        (held to 1.25x the JAX package's from
        scripts/torch_port_reference_klsum.py, and to 0.1x the untrained
        network's), the UQ mean and standard deviation against the
        Monte-Carlo ones of the direct solves; steps/s through fit and
        resident, one profiled resident step.
     K. round-robin NS training through K6 (the reference's
        e1_ns_ldc_resmin setup): the 64^2 Re-100 lid-driven cavity, a
        three-field DirectField from zeros, one optimizer per field
        residual scoped to its field, Adam 3e-2 (x0.1 after 40 updates
        each), ``OptimizerSwitch`` at epoch 300 to [LBFGS(u), LBFGS(v),
        Adam(p)], 308 epochs (each LBFGS objective, as JAX's, runs optax's
        L-BFGS over all three fields, its turn's first update evaluated
        anew, the other two fields pinned after each update); each
        objective's loss and the midline
        figures at the switch and at the end against the JAX package's
        (scripts/torch_port_reference_rr.py); the run split in two halves
        through ``resume_from`` lands on the unbroken run's fields; three
        epochs more under the Trainer's profiler, whose trace must name
        the K6 launches.
     L. the single-instance physics, each case at the grid of its JAX
        figure (scripts/torch_port_reference_physics.py; no kernel of the
        table lies on it): L1 Helmholtz, the k = 0.5 MMS at 65^2 by LBFGS
        (one epoch profiled: idle share, top device operations) and the
        indefinite k = 12 MMS by GMRES through ``module_linear_solve``; L2
        SUPG advection-diffusion, the nu = 0.05 MMS at 33^2 and at 65^2
        from four rounding-level starts (their median against JAX's) and
        the inlet skew to the mesh at 64^2 (bounded, its centre within 0.05
        of JAX's); L3 space-time heat, Allen-Cahn (the A = 0 linear solve,
        then ``newton_solve``) and deg-2 Burgers at 33^2; L4 the two-dof and
        FDM Poisson strong forms; L5 eikonal SDFs: the teardrop airfoil at
        64^2 by LBFGS (mean |u| on the cloud, the sign structure), the
        circle at 64^2 and the sphere at 32^3 by ``gauss_newton_solve``
        (mean |u - sdf|), the FDM variant by LBFGS (its loss falls). MMS
        errors are held to 1.3x JAX's, SDF errors to 1.25x, each Newton
        and Gauss-Newton solve's final |F| or loss to 1.3x, and its steps
        to JAX's + 2 where JAX stopped below the cap.
     M. the last physics (scripts/torch_port_reference_topopt.py gives
        JAX's figures), on two paths: M1 the FSDT plate
        (examples/more_physics.py fsdt: ElasticFSDTDataset at 64^2, a
        three-field DirectField from zeros, the squared norm, LBFGS x 10
        for 100 epochs), the rel L2 of w on the free nodes against the
        float64 direct solve of the same operator (27 coloured probes of
        the affine residual, scipy) and the last loss, each at most 1.3x
        JAX's, the clamped walls below 1e-6; M2 RectangleIM,
        RectangleIMBack, CircleIMBack and LShaped at 64^2, Poisson2D's
        energy through K3 (K1 in its VJP), LBFGS x 10 for 50 epochs from
        zeros and three rounding-level starts, each case's median rel L2 on
        the free nodes against its direct solve at most 1.3x the larger of
        JAX's two float32 paths' medians (the figures sit on float32's
        floor); M3 ``TopOpt2D.optimize`` on the JAX test's 32^2 problem
        (80 outer iterations, every CG matvec through K1): the test's five
        criteria, the first compliance within 1e-4 of JAX's, the last at
        most 1.05x JAX's, ms an outer iteration and CG iterations a solve.
     N. the multi-device path (``diffnet_tpu_torch.parallel``): a process
        group of 4 ranks, NCCL with a card a rank, else (one card) gloo
        with the 4 ranks sharing it, the halo rows and all-reduces through
        host memory, the compute on the card; its line prints backend and
        world. The kernel library is built before the spawn; a rank that
        fails or outlives its timeout fails the slice. N1 the row-split K1
        (``poisson_stiffness_spatial_fused``, 4 row blocks) at 1 x 512^2
        and 32 x 512^2 against the unsplit K1 within 2e-6 x max(1, max
        |K u|), and 50 fixed CG iterations on 512^2 with that matvec (the
        inner products all-reduced) against the unsplit solve (iterate
        within 2e-5 x max(1, max |x|), relres within 1e-4 relative); N2
        the depth-split K5 at 1 x 128^3 and its VJP through the exchange's
        backward against autograd through the unsplit K5; the times of
        each split call with and without its exchange. N3 slice B's 512^2
        x 32 resmin as 8 rows a rank, 10 Adam steps through
        ``Trainer.fit``: K2 once a step on each rank, the losses within
        1e-5 of one process's on the batch of 32, the gradient
        all-reduce's ms. Then ``dryrun_multigpu(4)`` (its workloads (a),
        (b) and (d) split over data and space). (Slice I's UNet3D(16)
        over ranks is Q2's, over data x space.)
     O. the split solvers, the split NS residual and the root-norm losses
        over 4 ranks, as slice N's group runs (``slice_o_rank``), each
        against one process on the same card: O1 slice D's 513^2
        54x-contrast MG-CG in D3's variant with the rows split over
        'space' (``multigrid_preconditioner(mesh=)``: levels 513-257-129-65
        on row blocks through K4, 33 gathered; the outer matvec through
        K4 on halo'd blocks), 14 iterations: the iterate within 2e-5 x
        max(1, max |x|), the relres under its own and the element path's
        operator within slice D's bound; O2 slice G1's 129^2 cavity
        residual (mean-control gauge) on row blocks, through K6's row-block
        entry and without it, within 2e-6 x max(1, max |R|); O3 one cycle
        of GMRES(10) on that residual's Jacobian action (torch.func.jvp
        through the exchange and the gauge's all-reduce) within 1e-4 x
        max |dx|; O4 G3's 8 x 256^2 cavity with the Frobenius loss
        (``batch_reduction="global"``), 2 rows a rank, 2 Adam steps: the
        losses within 1e-5 and step 1's all-reduced gradient within 1e-5
        of its largest entry. Beside each: the split call's ms and its
        exchange or all-reduce share (host clock).
     Q. the U-Nets and the IBN energy split over 'space' (``UNet(mesh=)``,
        ``IBNPoisson2D(mesh=)``, the loader's ``space_axis``), 4 ranks as
        slice N's group runs (``slice_q_rank``), each path from
        ``seeded_params`` against one process on the same card, TF32 off:
        Q1 IBNPoisson2D(source_from="inputs") with the JAX CLI's
        UNet(base_filters=16) on a 256^2 image ensemble, data 1 x space 4,
        batch 4, 5 Adam steps (every level on row blocks); Q2 slice I's
        UNet3D(16) IBNPoisson3D at 32^3, data 2 x space 2, 8 a data rank,
        5 Adam steps (the fifth Down gathered). Each: the losses within
        1e-4 of one process's, step 1's gradient entry by entry within
        1e-5 of its L2 norm, the parameters after step 1 (Q_PARAM_*), a
        warm step's ms split and in one process, the share of the split
        step in the halo exchanges and the norms' and energy's
        all-reduces, and the peak memory a rank.
     P. the entry points: the port's example CLIs
        (``diffnet_tpu_torch.examples``) in-process through ``main(argv)``,
        their stdout kept, each entry one line with its figures, seconds
        and launches (the ``entry_points`` path: K1, K3, K5 and K6 must
        launch). P1 ``poisson_mms_2d`` at 64^2 resmin + LBFGS with
        ``--fused-kernels`` (rel L2 <= 2.6e-4); P2 the same CLI at 513^2
        by MG-CG (K1 on the fine level and the CG, the V-cycle one CUDA
        graph; rel L2 <= 1.3x the JAX CLI's 4.122e-4 and <= 1.3x its
        3.195e-6 with the stiffness kernel on, and the solve's seconds;
        one replay of the V-cycle's graph: each kernel's count among the
        graph's nodes equal to what the replay adds to its launch count,
        the profiler's trace showing no kernel more often);
        P3 ``poisson_3d`` 17^3 through K5 (E1's limit); P4
        ``ldc_validation --re 1000 --solver newton --domain-size 129
        --fused-kernels``: 33 -> 65 -> 129 grid-continuation Newton-Krylov
        through K6 against Ghia, Ghia & Shin's table, the midline errors
        at most 1.1x the JAX package's 0.0356 / 0.0375, |F| < 1e-6 and
        the Newton iterations at most JAX's 12/7/7 + 3 at every level,
        each level's seconds, and one replay of the last GMRES step's
        graph checked as P2's (K6); P5 ``klsum_uq`` at 64^2, 3 epochs,
        through K3 and K1, then ``query_run`` on its run directory: best.ckpt,
        q_mean.npy and q_mean.vti written, q_mean finite, the reloaded
        parameters equal to the saved and (when the last epoch was the
        best) the trained ones; P6 every other CLI and physics once, at
        tests/test_examples_smoke.py's argv (ns_fps and
        eikonal_parametric at examples/run_all.sh's): each finishes and
        writes its artifacts, its seconds recorded (helmholtz, allen-cahn
        and the 2D eikonal at their training argvs only, and no 17^2
        ldc_validation: slices L and P4 run those solvers).
     R. the study scripts as entry points (``convergence_study``,
        ``precision_study``, ``fps_validation`` of
        ``diffnet_tpu_torch.examples``), in-process through ``main(argv)``
        (the ``studies`` path: K1 must launch), each held to the JAX
        package's figures (scripts/torch_port_reference_studies.py): R1
        the convergence study's --quick Poisson resmin rows, deg 1 at 17^2
        and 33^2 through K1 (``--fused-kernels``), deg 2 at 9^2 and 17^2
        and deg 3 at 7^2 and 13^2 plain (they refuse the flag): each error
        at most 1.3x JAX's at its grid, each rate at least JAX's less
        0.25, the seconds and K1 launches of each solve; R2 the precision
        study with ``--fused-kernels``: section 1 (bf16 against float32
        residuals at 128^2 and 512^2, the library policy's at most 1.3x
        JAX's, K1's route beside it), section 2 (the 64^2 MMS by 300
        updates of the port of optax's L-BFGS under f32, bf16-residual and
        bf16-accum; each at most 1.3x JAX's, the bf16 rows also below 0.95,
        off their zero start), 2b (32^2, 6,000 Adam steps in
        float32 and bf16) and section 3 (elem/s of the library policy and
        K1 in float32 and bf16 at 512^2 x 8, the card's name and power
        limit beside them); then, off the path, K1's bf16 residual against
        its float32 one within 8e-3 x max(1, max |float32|); R3 the
        flow-past-square ns10 channel at h = 1/4 (49 x 25): the u, v and p
        midline cuts within 1e-4 x max |u| of JAX's solution, the Newton
        iterations at most JAX's + 2, |F| and the seconds.
     S. ``Trainer(steps_per_call=10)``, each chunk of 10 Adam steps one
        CUDA graph (the ``training_2d_graphed`` path), on slice B's and
        C's modules (512^2 x 32 through K2 and K3, 10 batches an epoch)
        from the same start as ``steps_per_call=1``: 3 epochs each (the
        first chunk runs eagerly and captures, the later ones replay),
        every step's loss within ``S_LOSS_RTOL`` and the final field
        within ``S_FIELD_ATOL`` x max |u| of the single steps', K2 and K3
        launched 10 times each epoch (a replay counts the graph's
        kernels); steps/s through ``fit`` (the module's loader) and
        resident (``fit`` on 10 batches already on the card) at K = 1 and
        K = 10, epochs 2-3, beside the card's name and power limit.
  16. resident steps: steps/s of the 512^2 x 32 training steps with the
     batch on the card (fused and unfused) and of G3's NS step; 10 steps
     of each fused 512^2 x 32 loss (K2's, K3's) under ``torch.profiler``:
     device busy and wall ms a step, idle share, top device operations.
  17. path shapes: each kernel timed again at every shape its slices run
     it at (``SLICE_SHAPES``); the shape where most of its launches on the
     paths above ran (the slice with the most launches) gives
     ``ms_path_shape`` and ``path_shape`` on the kernel table line.
  Then the kernel table line (all seven kernels; K1's also carries its
  bf16 time, bound and largest error, K4's and K6's their times at slice
  O's block shapes, ``ms_blocks``) and, last, ``{"ok": true, "device":
  ...}``.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                   register_optimizer_step_pre_hook)

from diffnet_tpu_torch.core import fem
from diffnet_tpu_torch.core.geometry import (occupancy_from_cloud,
                                             sample_ellipse_cloud,
                                             sample_sphere_cloud)
from diffnet_tpu_torch.core.quadrature import make_basis
from diffnet_tpu_torch.data import single_instances
from diffnet_tpu_torch.data import (AdvDiff2dRectangle,
                                    AllenCahnIceMeltRectangle,
                                    CuboidManufactured, ElasticFSDTDataset,
                                    InMemoryDataset,
                                    KLSumStochastic, NSLDCDataset,
                                    NumpyLoader,
                                    RectangleHelmholtzManufactured,
                                    RectangleManufactured,
                                    SpaceTimeRectangleManufactured,
                                    SyntheticPointClouds, TopoDataset3D,
                                    nurbs_curve, synthesize_topology_3d)
from diffnet_tpu_torch.data.gen_input import sobol_coefficients
from diffnet_tpu_torch.interop import (flax_shapes, params_from_jax,
                                       seeded_params)
from diffnet_tpu_torch.models import (AE, DGCNN2D, DirectField,
                                      GoodNetwork, ImmDiffLargeNormals,
                                      UNet, UNet3D, knn_indices)
from diffnet_tpu_torch.ops import _build
from diffnet_tpu_torch.ops import ns_residual as k6
from diffnet_tpu_torch.ops import poisson_energy as k3
from diffnet_tpu_torch.ops import poisson_loss_grad as k2
from diffnet_tpu_torch.ops import poisson_residual as k1
from diffnet_tpu_torch.ops import poisson_residual_3d as k5
from diffnet_tpu_torch.ops.poisson_residual_3d import (
    poisson_stiffness_action_3d)
from diffnet_tpu_torch.ops import stencil_apply as k4
from diffnet_tpu_torch.parallel import (all_reduce_sum, gather_block,
                                        halo_exchange, local_block,
                                        make_mesh,
                                        poisson_stiffness_spatial_fused,
                                        poisson_stiffness_spatial_fused_3d,
                                        rank_device, run_ranks)
from diffnet_tpu_torch.parallel import mesh as mesh_mod
from diffnet_tpu_torch.parallel.dryrun import dryrun_multigpu
from diffnet_tpu_torch.pde import (AdvDiff2D, AllenCahnIceMelt,
                                   BurgersSpaceTime, Eikonal2D, Eikonal3D,
                                   EikonalFDM2D, ElasticFSDT, Helmholtz2D,
                                   IBNPoisson2D,
                                   IBNPoisson3D, NavierStokes, Poisson2D,
                                   Poisson3D, PoissonFDM2D, PoissonTwoDof2D,
                                   SpaceTimeHeat, TopOpt2D,
                                   eikonal_gn_residual, ldc_bcs,
                                   signed_occupancy_init)
from diffnet_tpu_torch.train import (Callback, OptimizerSwitch, Trainer, cg,
                                     extract_verified, gauss_newton_solve,
                                     gmres,
                                     module_linear_solve,
                                     multigrid_preconditioner, newton_solve,
                                     ns_newton_solve, query_statistical,
                                     solve_linear,
                                     stokes_block_preconditioner,
                                     stencil_matvec)
from diffnet_tpu_torch.train import krylov
from diffnet_tpu_torch.train.stencil import SplitStencil
from diffnet_tpu_torch.utils import (export_forward, field_to_obj,
                                     load_exported, save_exported,
                                     surface_nets)

POISSON_SRC = "diffnet_tpu_torch/csrc/poisson2d.cu"
KERNELS = {   # name -> (module, its launch count, its source, the TPU kernel)
    "poisson_stiffness_action": (k1, "launches", POISSON_SRC,
                                 "diffnet_tpu/ops/poisson_residual.py:291"),
    "poisson_resmin_loss_grad": (k2, "launches", POISSON_SRC,
                                 "diffnet_tpu/ops/poisson_loss_grad.py:98"),
    "poisson_energy": (k3, "launches", POISSON_SRC,
                       "diffnet_tpu/ops/poisson_energy.py:151"),
    "stencil_apply_2d": (k4, "launches", "diffnet_tpu_torch/csrc/stencil2d.cu",
                         "diffnet_tpu/ops/stencil_apply.py:178"),
    "poisson_stiffness_action_3d": (
        k5, "launches", "diffnet_tpu_torch/csrc/poisson3d.cu",
        "diffnet_tpu/ops/poisson_residual_3d.py:450"),
    "stencil_apply_3d": (k4, "launches_3d",
                         "diffnet_tpu_torch/csrc/stencil3d.cu",
                         "diffnet_tpu/ops/stencil_apply.py:425"),
    "ns_vms_residual": (k6, "launches", "diffnet_tpu_torch/csrc/ns2d.cu",
                        "diffnet_tpu/ops/ns_residual.py:375"),
}
KERNEL_SYMBOLS = {   # name -> the __global__ function its wrapper launches
    "poisson_stiffness_action": "stiffness_kernel",
    "poisson_resmin_loss_grad": "loss_grad_kernel",
    "poisson_energy": "energy_kernel",
    "stencil_apply_2d": "stencil_apply_kernel",
    "poisson_stiffness_action_3d": "stiffness3d_kernel",
    "stencil_apply_3d": "stencil_apply_3d_kernel",
    "ns_vms_residual": "ns_vms_kernel",
}
# Tolerances, kernel against plain version (float32, sums in other orders):
FIELD_ATOL = 2e-6      # K1/K4/K5 fields, times max(1, max |ref|): O(1) terms
GRAD_RTOL = 1e-5       # K2 gradient, of its largest entry (entries ~O(10))
SCALAR_RTOL = 1e-5     # K2 loss, K3 energy
VJP_ATOL = 2e-6        # gradients at 65^2 and 17^3, times max(1, max |ref|)
L2_LIMIT = 2.6e-4      # slice A final rel L2
FIRST_LOSS_RTOL = 1e-4  # slices B, E2: kernel vs unfused first loss
RELRES_LIMIT = 1.8e-5  # slice D: twice the JAX package's 8.92e-6 at 513^2
SOLVE_GRID, SOLVE_ITERS = 513, 14   # slice D: bench.py's _solve_time
# The JAX package's figures on the same problems, on a CPU
# (scripts/torch_port_reference_3d.py): slice E1's final rel L2 and slice
# F's relative residual. E1 is held to 1.3x, F to 2x.
JAX_E1_REL_L2 = 0.02751881815493107
JAX_F_RELRES = 3.352927819832985e-07
E1_LIMIT = 1.3 * JAX_E1_REL_L2
RELRES_LIMIT_3D = 2.0 * JAX_F_RELRES
SOLVE_GRID_3D, N_COARSE_3D = 129, 9   # slice F: levels 129-65-33-17-9
BF16_ATOL = 8e-3       # bf16 K1 field, K3 energy, times max(1, |plain|):
#                        kernel and plain version each round once from f32
K6_ATOL = 2e-5         # K6 residuals, times max(1, max |plain|): the JAX
#                        package's kernel-vs-XLA tolerance (test_pallas_kernel)
# Slice G1, the lid-driven cavity (scripts/torch_port_reference_flow.py
# builds the same problem and gives the JAX package's figures on a CPU).
G1_GRID, G1_RE, G1_NEWTON_ITERS = 129, 100.0, 15
G1_UNFUSED_STEP1_RTOL = 1e-5   # without K6 (one Newton step): |F| after
#                                it, against the fused solve's after its first
#                                (both GMRES directions from Jacobian actions
#                                that differ by rounding: 7.6e-8 apart)
JAX_G1 = {"final_F": 1.326517917732417e-07, "newton_steps": 4,
          "u_min_x05": -0.20309318602085114,
          "v_min_y05": -0.24506235122680664,
          "v_max_y05": 0.171223983168602,
          "p_min_y05": -0.03475015237927437,
          "p_max_y05": -0.0009885188192129135}
MIDLINE_ATOL = 2e-3    # G1 midline extrema and pressure, against JAX's
LID_ATOL = 1e-5        # G1, G2: the lid profile
G2_GRID, G2_EPOCHS, G2_DROP = 64, 20, 0.05
G3_GRID, G3_BATCH = 256, 8
FIRST_LOSS_RTOL_FLOW = 1e-5   # G2, G3: kernel vs unfused first loss
# Slice H, the IBN flagship (reference IBN_2D.py): scripts/
# torch_port_reference_ibn.py trains the same configuration in the JAX
# package on a CPU and scores the same held-out clouds. Both networks start
# from the weights seeded_params draws from H_INIT_SEED; the runs differ in
# rounding only, which 640 Adam steps amplify, so the held-out rel L2 is
# held to a factor of JAX's. Batches of 64 give 160 steps at the full
# rate before the first milestone (batches of 512 gave 20, and a held-out
# rel L2 of 1.098 in JAX, no better than untrained).
H_GRID, H_TRAIN, H_POINTS, H_BATCH = 32, 1024, 120, 64
H_LR, H_MILESTONES, H_EPOCHS, H_INIT_SEED = 3e-4, (10, 15, 30), 40, 0
H_HELDOUT, H_HELDOUT_SEED = 8, 1
H_PREFETCH_EPOCHS = 11   # a second fit, its loader with prefetch=2
H2_BATCH = 512           # slice H2's batches of H's clouds
JAX_H = {"first_epoch_loss": 1142.707275390625,
         "last_epoch_loss": 30.178260803222656,
         "heldout_rel_l2_mean": 0.4035884775221348,
         "heldout_energy_gap_mean": 2.0357313783532933,
         "untrained_heldout_rel_l2_mean": 2.775232970714569}
H_REL_L2_FACTOR = 1.25
EXPORT_RTOL = 1e-6     # the exported AE against the module's forward
# Slice I, the 3D IBN (reference IBN_3D.py) at JAX's UNet3D width:
# scripts/torch_port_reference_ibn3d.py trains the same configuration in
# the JAX package on a CPU and scores the same held-out topologies against
# the same direct solve. Both networks start from the same weights, drawn
# with numpy from I_INIT_SEED (interop.seeded_params); the runs differ in
# rounding only, which 288 Adam steps amplify, so the held-out rel L2 is
# held to a factor of JAX's, as slice H's is.
I_GRID, I_TRAIN, I_BATCH, I_FILTERS = 32, 64, 8, 16
I_LR, I_EPOCHS, I_INIT_SEED = 1e-3, 36, 0
I_HELDOUT_SEEDS = (1000, 1001, 1002, 1003)
I_SOLVE_TOL = 1e-6     # float32 CG's recursive residual stalls near 1.4e-7 at
#                        32^3; at 1e-6 (~70 iterations) the true one is at
#                        its float32 floor already (~7e-5)
JAX_I = {"first_epoch_loss": 129.5518341064453,
         "last_epoch_loss": 28.711841583251953,
         "heldout_rel_l2_mean": 0.08806608710438013,
         "heldout_energy_gap_mean": 0.027828215124504514,
         "untrained_heldout_rel_l2_mean": 1.1487959921360016}
I_REL_L2_FACTOR = 1.25
# Slice H2, the point-cloud inputs: slice H's clouds, batch and rate
H2_EPOCHS, H2_K, H2_LOWEST = 10, 20, 16
# Slice J, the parametric KL-sum UQ path (examples/klsum_uq.py at BASELINE.md's
# 64^2 KL-sum configuration): scripts/torch_port_reference_klsum.py trains
# the same configuration in the JAX package on a CPU from the same initial
# weights (interop.seeded_params, J_INIT_SEED) and scores the same held-out
# instances against the same direct solves. Epochs are the only cut: 3 of
# BASELINE.md's ceil(200000 / (4096 / 32)) = 1563, where JAX's held-out rel
# L2 is 0.0193 against 0.518 untrained (0.031 after 2, 0.0147 after 5).
J_GRID, J_TRAIN, J_BATCH, J_FILTERS = 64, 4096, 32, 16
J_LR, J_EPOCHS, J_INIT_SEED = 3e-4, 3, 0
J_QUERY, J_QUERY_SEED, J_HELDOUT = 256, 1, 64
J_SOLVE_TOL = 1e-6     # CG on 64^2 in float32: the true relres is ~9e-6 there
JAX_J = {"first_epoch_loss": 0.0007875574519857764,
         "last_epoch_loss": 0.00013956986367702484,
         "heldout_rel_l2_by_epoch": [0.13997326628305018,
                                     0.03099561037379317,
                                     0.019289986084913835],
         "heldout_rel_l2_mean": 0.019289986084913835,
         "heldout_energy_gap_mean": 0.05783042520968022,
         "untrained_heldout_rel_l2_mean": 0.5183683596551418,
         "uq_mean_rel_l2": 0.004498706664890051,
         "uq_sdev_rel_l2": 0.27083393931388855}
J_REL_L2_FACTOR = 1.25
J_UNTRAINED_FACTOR = 0.1   # trained held-out rel L2 <= 0.1 x the untrained
# Slice K, round-robin NS training (the reference's e1_ns_ldc_resmin setup)
# at 64^2: scripts/torch_port_reference_rr.py runs the same configuration
# in the JAX package on a CPU. Adam on fields from zeros amplifies rounding
# where a gradient is near zero (its first steps are ~lr x sign(g)), so the
# packages part within a few epochs (the CPU port is 0.03% off JAX's loss
# at epoch 4, 7% at epoch 10); the figures are held loosely, tighter at the
# switch (Adam only) than at the end (after the LBFGS steps, whose line
# searches differ too): at the switch each objective's loss within a factor
# K_SWITCH_FACTOR of JAX's and the midline figures within
# K_SWITCH_MIDLINE_ATOL; at the end each loss at most K_END_FACTOR x
# JAX's and the midlines within K_END_MIDLINE_ATOL (the CPU port: losses
# 0.98-1.10x at the switch, 0.09-1.02x at the end; midlines within 0.0064
# and 0.025).
K_GRID, K_LR, K_MILESTONE, K_SWITCH, K_EPOCHS = 64, 3e-2, 40, 300, 308
K_LBFGS_ITERS, K_SWITCH_TO = 10, ["lbfgs", "lbfgs", "adam"]
K_DROP = 10.0          # objective 0 must fall this much by the switch
JAX_K = {"start_objective_losses": [0.0044500576332211494,
                                    5.850568777532317e-05,
                                    4.801750947081018e-06],
         "at_switch": {"objective_losses": [0.0003801248094532639,
                                            5.134506500326097e-05,
                                            1.347121360595338e-05],
                       "u_min_x05": -0.11184895038604736,
                       "v_min_y05": -0.004890750627964735,
                       "v_max_y05": 0.004857709165662527,
                       "p_min_y05": -0.021071413531899452,
                       "p_max_y05": 0.01999126747250557},
         "end": {"objective_losses": [0.0002863926056306809,
                                      0.00015093886759132147,
                                      1.9991213775938377e-05],
                 "u_min_x05": -0.11128740012645721,
                 "v_min_y05": -0.008940170519053936,
                 "v_max_y05": 0.007819668389856815,
                 "p_min_y05": -0.04682543873786926,
                 "p_max_y05": 0.03809063136577606}}
K_SWITCH_FACTOR, K_SWITCH_MIDLINE_ATOL = 1.5, 0.02
K_END_FACTOR, K_END_MIDLINE_ATOL = 3.0, 0.05
K_RESUME_ATOL = 1e-6   # resumed against unbroken fields, x max |field|
K_PROFILED_EPOCHS = 3  # under profile_dir: LBFGS(u), LBFGS(v), Adam(p)

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at 700 W):
# HBM bytes/s and fp32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations of each kernel's algebra, counted once (no recomputed
# element): K1's sum-factorised element body (~49 an element), K2 two of
# them (K u and K R) plus 5 a node (residual, mask, square, sum, 2x), K3's
# element energy and load (~61 an element), K4 one FMA a tap, K5 the
# sum-factorised trilinear body of csrc/poisson3d.cu (3 axis parts of 88
# plus the 16 of the signed corner sums, 280 an element, and 7 adds a node
# to assemble the eight corners), K6 the VMS body of csrc/ns2d.cu (3 x 44
# Gauss-point values, 4 x 70 a Gauss point, 3 x 40 projection tails: 532
# an element, FMA as two, and 9 adds a node).
FLOPS = {"poisson_stiffness_action": (49, 0),      # (a element, a node)
         "poisson_resmin_loss_grad": (98, 5),
         "poisson_energy": (61, 0),
         "stencil_apply_2d": (0, 18),
         "poisson_stiffness_action_3d": (280, 7),
         "stencil_apply_3d": (0, 54),
         "ns_vms_residual": (532, 9)}


_START = time.perf_counter()   # the phases' lines carry seconds since it


def emit(obj: dict) -> None:
    """One JSON line; a phase's also carries ``t_s``, the script's seconds
    so far (where the time limit goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def exact(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def forcing(x, y):
    return 2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y)


def reset_counts() -> None:
    for mod, attr, _, _ in KERNELS.values():
        setattr(mod, attr, 0)


def counts() -> dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr, _, _) in KERNELS.items()}


def bound(name: str, tensors, shape) -> dict:
    """The least time the card could take for `name`'s work on these
    tensors: the larger of their bytes (each input read once, each output
    written once) over the peak memory rate and the kernel's operations
    (FLOPS, counted on `shape`'s elements and nodes) over the fp32 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    B, *spatial = shape
    elements = B * math.prod(n - 1 for n in spatial)
    per_elem, per_node = FLOPS[name]
    ops = per_elem * elements + per_node * B * math.prod(spatial)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in counts().items()}


def lbfgs_info(opt) -> dict:
    """A line's note of the Trainer's ``"lbfgs"``: optax's L-BFGS with its
    zoom line search (``train/lbfgs.py::ZoomLBFGS``), its updates and its
    evaluations of the loss."""
    st = opt.state[opt.param_groups[0]["params"][0]]
    return {"optimizer": "zoom", "updates": st["count"],
            "evaluations": st["evaluations"]}


def basis_for(ny: int, nx: int, aniso: bool, dev) -> fem.BasisTables:
    h = ((0.7 / (nx - 1), 1.9 / (ny - 1)) if aniso
         else (1.0 / (nx - 1), 1.0 / (ny - 1)))
    return fem.BasisTables(make_basis(2, 1, h=h)).to(dev)


def basis_3d(shape, aniso: bool, dev) -> fem.BasisTables:
    nz, ny, nx = shape[1:]
    h = ((0.7 / (nx - 1), 1.9 / (ny - 1), 1.3 / (nz - 1)) if aniso
         else (1.0 / (nx - 1), 1.0 / (ny - 1), 1.0 / (nz - 1)))
    return fem.BasisTables(make_basis(3, 1, h=h)).to(dev)


def cuda_ms(fns: dict, reps: int = 20, inner: int = 10, warmup: int = 3,
            queued: bool = True) -> dict[str, float]:
    """Median over `reps` runs of the CUDA-event time of `inner` back-to-back
    calls, per call, for each callable; the callables take turns.

    queued: first hold the stream in a spin kernel (``torch.cuda._sleep``)
    for 1.5x the host's measured time to enqueue the `inner` calls, so the
    calls wait in the queue and run without gaps: the time is the device's
    even where a call's host work (checks, allocation, the launch itself)
    outlasts its kernel, as it does for kernels of a few tens of us. Without
    it a short kernel reads the host's time per call. A plain version whose
    launches overflow the queue (~1k pending) can still read the host's."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    enqueue_s = {}
    for k, fn in fns.items():
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        enqueue_s[k] = time.perf_counter() - t0
        torch.cuda.synchronize()
    # the SM clock in Hz (the property is in kHz; 2 GHz where it is absent)
    hz = getattr(torch.cuda.get_device_properties(0), "clock_rate",
                 2_000_000) * 1e3
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(int(1.5 * enqueue_s[k] * hz) + 10_000)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / inner)
    return {k: statistics.median(v) for k, v in times.items()}


def phase_device(dev) -> str:
    if not torch.cuda.is_available():
        fail("CUDA is not available; the port's kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "kind": torch.cuda.get_device_name(dev),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.load_library()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": so.name, "ptxas": ptxas})


# K1 and K3 (float32 and bf16) at each shape; K2 and K3 (float32) at those
# of K2_K3_SHAPES. 1 x 513^2 is slice D2's fine level; 1 x 2^2,
# 3 x 129 x 257, 1 x 100 x 77 and 1 x 40 x 65 hit the tile edges (widths
# that are no multiple of K1's and K3's 64 columns or K2's 61). Slice R
# runs K1 at 1 x 17^2 and 1 x 33^2 (R1), 2 x 128^2, 2 x 512^2 and
# 8 x 512^2 (R2).
K1_SHAPES = ((2, 33, 33, True), (2, 40, 40, False), (2, 24, 49, False),
             (1, 2, 2, False), (3, 129, 257, False), (1, 100, 77, False),
             (1, 40, 65, False), (1, 513, 513, False), (32, 512, 512, False),
             (1, 17, 17, False), (1, 33, 33, False), (2, 128, 128, False),
             (2, 512, 512, False), (8, 512, 512, False))
K2_K3_SHAPES = ((2, 33, 33), (2, 40, 40), (1, 40, 65), (1, 100, 77),
                (3, 129, 257), (1, 2, 2), (1, 513, 513), (32, 512, 512))
# K2 and K3 (both types) also at every tile height the kernels take
K2_K3_STRIP_SHAPES = ((1, 513, 513), (32, 512, 512))


def _k2_k3_strips(u, nu, Nf, bc, f, tb, loss_p, grad_p, E_p, Eb_p) -> dict:
    """K2 and K3 (float32 and bf16) at every tile height the kernels take,
    through the launch the wrappers make (not counted), against the plain
    versions: the largest relative error of each."""
    errs = {}
    for ty in k2.STRIPS:
        loss, grad = k2.loss_grad_at_strip(u, nu, Nf, bc, tb, ty)
        lerr = abs(float(loss) - float(loss_p))
        gerr = float((grad - grad_p).abs().max())
        if lerr > SCALAR_RTOL * abs(float(loss_p)) or \
                gerr > GRAD_RTOL * float(grad_p.abs().max()):
            fail(f"K2 at {list(u.shape)}, tile height {ty}: loss err "
                 f"{lerr}, grad err {gerr}")
        errs[f"K2_ty{ty}"] = gerr / float(grad_p.abs().max())
    ub, nub, fb = u.bfloat16(), nu.bfloat16(), f.bfloat16()
    for ty in k3.STRIPS:
        eerr = abs(float(k3.energy_at_strip(u, nu, f, tb, ty)) - float(E_p))
        berr = abs(float(k3.energy_at_strip(ub, nub, fb, tb, ty)) - Eb_p)
        if eerr > SCALAR_RTOL * abs(float(E_p)) or \
                berr > BF16_ATOL * max(1.0, abs(Eb_p)):
            fail(f"K3 at {list(u.shape)}, tile height {ty}: errs {eerr}, "
                 f"bf16 {berr}")
        errs[f"K3_ty{ty}"] = eerr / abs(float(E_p))
        errs[f"K3_bf16_ty{ty}"] = berr
    return errs


def phase_kernels(dev) -> dict:
    """K1-K3 against their plain versions, K1 and K3 in float32 and bf16;
    times at 512^2 x 32."""
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {name: 0.0 for name in KERNELS}
    times = {}
    for B, ny, nx, aniso in K1_SHAPES:
        tb = basis_for(ny, nx, aniso, dev)
        u, nu, Nf, f = (torch.rand((B, ny, nx), generator=g, device=dev)
                        for _ in range(4))
        nu = nu + 0.5
        bc = torch.zeros((ny, nx), device=dev)
        bc[[0, -1], :] = 1
        bc[:, [0, -1]] = 1
        row = {"phase": "kernels", "shape": [B, ny, nx],
               "tolerance": {"K1_atol": FIELD_ATOL, "K2_grad_rtol": GRAD_RTOL,
                             "scalar_rtol": SCALAR_RTOL}}

        K = k1.stiffness_action(u, nu, tb)
        Kp = k1.stiffness_action_plain(u, nu, tb)
        R = k1.poisson_residual_fused(u, nu, Nf, bc, tb)
        Rp = torch.where(bc > 0.5, torch.zeros_like(Kp), Kp - Nf)
        torch.cuda.synchronize()
        for name, a, b in (("K1", K, Kp), ("K1_residual", R, Rp)):
            err = float((a - b).abs().max())
            ref = float(b.abs().max())   # 0 for the residual at 2^2
            row[name] = {"max_abs_err": err, "rel_err": err / max(ref, 1.0)}
            errs["poisson_stiffness_action"] = max(
                errs["poisson_stiffness_action"], err)
            if err > FIELD_ATOL * max(1.0, ref):
                fail(f"{name} at {row['shape']}: max abs err {err}")
        # bf16 fields (K1 and K3 take them): one rounding from f32 each
        ub, nub, fb = u.bfloat16(), nu.bfloat16(), f.bfloat16()
        Kb = k1.stiffness_action(ub, nub, tb)
        Kbp = k1.stiffness_action_plain(ub, nub, tb)
        Eb = float(k3.energy(ub, nub, fb, tb))
        Ebp = float(k3.energy_plain(ub, nub, fb, tb))
        torch.cuda.synchronize()
        err = float((Kb.float() - Kbp.float()).abs().max())
        ref = float(Kbp.float().abs().max())
        row["K1_bf16"] = {"dtype": str(Kb.dtype), "max_abs_err": err,
                          "rel_err": err / max(ref, 1.0)}
        row["K3_bf16"] = {"energy": Eb, "abs_err": abs(Eb - Ebp)}
        errs["poisson_stiffness_action_bf16"] = max(
            errs.get("poisson_stiffness_action_bf16", 0.0), err)
        if Kb.dtype != torch.bfloat16 or err > BF16_ATOL * max(1.0, ref):
            fail(f"K1 bf16 at {row['shape']}: {row['K1_bf16']}")
        if abs(Eb - Ebp) > BF16_ATOL * max(1.0, abs(Ebp)):
            fail(f"K3 bf16 at {row['shape']}: {row['K3_bf16']}")
        if (B, ny, nx) in K2_K3_SHAPES:
            loss, grad = k2.resmin_loss_grad(u, nu, Nf, bc, tb)
            loss_p, grad_p = k2.resmin_loss_grad_plain(u, nu, Nf, bc, tb)
            E = k3.energy(u, nu, f, tb)
            E_p = k3.energy_plain(u, nu, f, tb)
            torch.cuda.synchronize()
            gerr = float((grad - grad_p).abs().max())
            gref = float(grad_p.abs().max())
            lerr = abs(float(loss) - float(loss_p))
            eerr = abs(float(E) - float(E_p))
            # at 1 x 2^2 every node is masked: loss and gradient exactly 0
            row["K2"] = {"loss": float(loss), "loss_rel_err":
                         lerr / max(abs(float(loss_p)), 1e-30),
                         "grad_max_abs_err": gerr,
                         "grad_rel_err": gerr / max(gref, 1e-30)}
            row["K3"] = {"energy": float(E), "rel_err": eerr / abs(float(E_p))}
            errs["poisson_resmin_loss_grad"] = max(
                errs["poisson_resmin_loss_grad"], gerr)
            errs["poisson_energy"] = max(errs["poisson_energy"], eerr)
            if gerr > GRAD_RTOL * gref or lerr > SCALAR_RTOL * abs(
                    float(loss_p)):
                fail(f"K2 at {row['shape']}: {row['K2']}")
            if eerr > SCALAR_RTOL * abs(float(E_p)):
                fail(f"K3 at {row['shape']}: {row['K3']}")
        if (B, ny, nx) in K2_K3_STRIP_SHAPES:
            row["strips"] = _k2_k3_strips(u, nu, Nf, bc, f, tb, loss_p,
                                          grad_p, E_p, Ebp)
        if B == 32:
            t = cuda_ms({
                "K1_plain": lambda: k1.stiffness_action_plain(u, nu, tb),
                "K1": lambda: k1.stiffness_action(u, nu, tb),
                "K1_bf16": lambda: k1.stiffness_action(ub, nub, tb),
                "K2_plain": lambda: k2.resmin_loss_grad_plain(u, nu, Nf, bc,
                                                              tb),
                "K2": lambda: k2.resmin_loss_grad(u, nu, Nf, bc, tb),
                "K3_plain": lambda: k3.energy_plain(u, nu, f, tb),
                "K3": lambda: k3.energy(u, nu, f, tb),
            })
            shape = (B, ny, nx)
            times = {
                "poisson_stiffness_action": dict(
                    ms=t["K1"], plain_ms=t["K1_plain"],
                    **bound("poisson_stiffness_action", (u, nu, K), shape),
                    ms_bf16=t["K1_bf16"], bound_ms_bf16=bound(
                        "poisson_stiffness_action", (ub, nub, Kb),
                        shape)["bound_ms"]),
                "poisson_resmin_loss_grad": dict(
                    ms=t["K2"], plain_ms=t["K2_plain"],
                    **bound("poisson_resmin_loss_grad",
                            (u, nu, Nf, bc, grad), shape)),
                "poisson_energy": dict(
                    ms=t["K3"], plain_ms=t["K3_plain"],
                    **bound("poisson_energy", (u, nu, f), shape))}
            row["ms"] = t
            row["bound_ms"] = {k: v["bound_ms"] for k, v in times.items()}
            row["bound_ms"]["poisson_stiffness_action_bf16"] = times[
                "poisson_stiffness_action"]["bound_ms_bf16"]
            gb = 1e-9 * B * ny * nx * 4
            row["kernel_GBps"] = {"K1": 3 * gb / (t["K1"] * 1e-3),
                                  "K2": 5 * gb / (t["K2"] * 1e-3),
                                  "K3": 3 * gb / (t["K3"] * 1e-3)}
        emit(row)
        del u, nu, Nf, f, ub, nub, fb, K, Kp, R, Rp, Kb, Kbp
    return {"errs": errs, "times": times}


# 1 x 513^2 .. 1 x 65^2: the levels on which slice D runs K4, at batch 1;
# then the halo'd row blocks slice O's split V-cycle runs it on (513 rows
# over 4 ranks: blocks of 128 and 129, halo'd 129 and 130; the coarser
# levels' 64/65, 32/33, 16/17)
STENCIL_SHAPES = ((2, 33, 33), (1, 40, 56), (3, 17, 129), (1, 513, 513),
                  (1, 257, 257), (1, 129, 129), (1, 65, 65), (32, 512, 512),
                  (1, 130, 513), (1, 129, 513), (1, 66, 257), (1, 65, 257),
                  (1, 34, 129), (1, 33, 129), (1, 18, 65), (1, 17, 65))
STENCIL_NODE_BYTES = 44   # 9 C planes and u read, out written, float32
# the split V-cycle's middle blocks, timed
STENCIL_BLOCKS_TIMED = ((1, 130, 513), (1, 66, 257), (1, 34, 129),
                        (1, 18, 65))


def phase_stencil_kernel(dev) -> dict:
    """K4 against its plain version, with a C per sample and a C shared by
    the batch (read with a batch stride of 0); its time at 512^2 x 32 and
    at slice O's block shapes."""
    g = torch.Generator(device=dev).manual_seed(2)
    err, times, block_times = 0.0, None, {}
    for B, ny, nx in STENCIL_SHAPES:
        u = torch.rand((B, ny, nx), generator=g, device=dev) - 0.5
        row = {"phase": "kernels_K4", "shape": [B, ny, nx],
               "tolerance": {"K4_atol": FIELD_ATOL}}
        for cb in dict.fromkeys((B, 1)):
            C = torch.rand((9, cb, ny, nx), generator=g, device=dev) - 0.5
            out = k4.apply_2d(C, u)
            ref = k4.stencil_apply_plain(C, u)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            row[f"C_batch_{cb}"] = {"max_abs_err": e, "rel_err": e / scale}
            err = max(err, e)
            if e > FIELD_ATOL * max(1.0, scale):
                fail(f"K4 at {row['shape']}, C batch {cb}: max abs err {e}")
            if B == 32 and cb == B:
                t = cuda_ms({"K4_plain": lambda: k4.stencil_apply_plain(C, u),
                             "K4": lambda: k4.apply_2d(C, u)})
                times = dict(ms=t["K4"], plain_ms=t["K4_plain"],
                             **bound("stencil_apply_2d", (C, u, out),
                                     (B, ny, nx)))
                row["ms"] = t
                row["bound_ms"] = times["bound_ms"]
                row["kernel_GBps"] = (STENCIL_NODE_BYTES * B * ny * nx
                                      / (t["K4"] * 1e-3) / 1e9)
            if (B, ny, nx) in STENCIL_BLOCKS_TIMED:
                t = cuda_ms({"K4_plain": lambda: k4.stencil_apply_plain(C, u),
                             "K4": lambda: k4.apply_2d(C, u)})
                block_times["x".join(map(str, (B, ny, nx)))] = dict(
                    ms=t["K4"], plain_ms=t["K4_plain"],
                    **bound("stencil_apply_2d", (C, u, out), (B, ny, nx)))
                row["ms"] = t
        emit(row)
    return {"err": err, "times": times, "block_times": block_times}


# 1 x 129^3: slice F's fine level; 4 x 64^3: bench.py's p3d shape
# (bench.py:1712); 1 x 128^3: bench.py:1405; 1 x 65^3: slice F's next
# level; 1 x 32^3: slice I's held-out solves (31 element columns, a
# part-filled warp tile). The kernel's edges: 45 columns (not a multiple of
# a warp's 32) and rows (nor of a block's 7), 3 planes (shorter than a
# strip), and the last node column right of a tile (nx - 1 a multiple of
# 32: 129, 65).
K5_SHAPES = (((2, 9, 9, 9), True), ((2, 17, 17, 17), False),
             ((2, 20, 17, 17), False), ((1, 129, 129, 129), False),
             ((4, 64, 64, 64), False), ((1, 128, 128, 128), False),
             ((1, 9, 45, 45), True), ((2, 3, 17, 17), False),
             ((1, 65, 65, 65), False), ((1, 32, 32, 32), False))
K5_TIMED = ((4, 64, 64, 64), (1, 128, 128, 128))
# every strip length the kernel takes, through its C entry point
K5_STRIP_SHAPES = ((1, 129, 129, 129), (1, 9, 45, 45))


def phase_k5(dev) -> dict:
    """K5 and its masked residual against their plain versions; times at
    4 x 64^3 and 1 x 128^3."""
    g = torch.Generator(device=dev).manual_seed(3)
    err, times = 0.0, {}
    for shape, aniso in K5_SHAPES:
        tb = basis_3d(shape, aniso, dev)
        u, nu, Nf = (torch.rand(shape, generator=g, device=dev)
                     for _ in range(3))
        nu = nu + 0.5
        bc = torch.zeros(shape[1:], device=dev)
        bc[[0, -1]] = 1
        bc[:, [0, -1]] = 1
        bc[:, :, [0, -1]] = 1
        row = {"phase": "kernels_K5", "shape": list(shape),
               "tolerance": {"K5_atol": FIELD_ATOL}}
        K = k5.stiffness_action_3d(u, nu, tb)
        Kp = k5.stiffness_action_3d_plain(u, nu, tb)
        R = k5.poisson_residual_fused_3d(u, nu, Nf, bc, tb)
        Rp = torch.where(bc > 0.5, torch.zeros_like(Kp), Kp - Nf)
        torch.cuda.synchronize()
        for name, a, b in (("K5", K, Kp), ("K5_residual", R, Rp)):
            e = float((a - b).abs().max())
            ref = float(b.abs().max())
            row[name] = {"max_abs_err": e, "rel_err": e / ref}
            err = max(err, e)
            if e > FIELD_ATOL * max(1.0, ref):
                fail(f"{name} at {row['shape']}: max abs err {e}")
        if shape in K5_STRIP_SHAPES:
            lib = _build.load_library()
            consts = k5.stiffness_consts_3d(tb.basis)
            strips = {}
            for tz in k5.STRIPS:
                out = torch.empty_like(u)
                if lib.poisson_stiffness_action_3d(
                        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *shape,
                        tz, *consts,
                        torch.cuda.current_stream(dev).cuda_stream) != 0:
                    fail(f"K5 at {row['shape']}, strip {tz}: launch failed")
                strips[tz] = float((out - Kp).abs().max())
            row["K5_strips"] = strips
            ref = float(Kp.abs().max())
            err = max(err, *strips.values())
            if max(strips.values()) > FIELD_ATOL * max(1.0, ref):
                fail(f"K5 at {row['shape']}: strips {strips}")
        if shape in K5_TIMED:
            t = cuda_ms({"K5_plain": lambda: k5.stiffness_action_3d_plain(
                u, nu, tb), "K5": lambda: k5.stiffness_action_3d(u, nu, tb)})
            b = bound("poisson_stiffness_action_3d", (u, nu, K), shape)
            times[shape] = dict(ms=t["K5"], plain_ms=t["K5_plain"], **b)
            row["ms"] = t
            row.update(b)
            row["kernel_GBps"] = b["bytes"] / (t["K5"] * 1e-3) / 1e9
            row["kernel_GFLOPps"] = b["operations"] / (t["K5"] * 1e-3) / 1e9
            # not queued: what back-to-back calls read when the host's work
            # for a call outlasts the kernel
            row["ms_not_queued"] = cuda_ms(
                {"K5": lambda: k5.stiffness_action_3d(u, nu, tb)},
                queued=False)["K5"]
        emit(row)
        del u, nu, Nf, K, Kp, R, Rp
    return {"err": err, "times": times[(4, 64, 64, 64)], "by_shape": {
        "x".join(map(str, k)): v for k, v in times.items()}}


# slice F's levels 129^3 .. 17^3 at batch 1, and bench.py:1513's 1 x 128^3
STENCIL3D_SHAPES = ((2, 9, 9, 9), (1, 10, 12, 14), (1, 129, 129, 129),
                    (1, 65, 65, 65), (1, 33, 33, 33), (1, 17, 17, 17),
                    (1, 128, 128, 128))


def phase_stencil3d_kernel(dev) -> dict:
    """K4-3D against its plain version, a C per sample and a C shared by
    the batch (the same at batch 1); its time at 1 x 128^3."""
    g = torch.Generator(device=dev).manual_seed(4)
    err, times = 0.0, None
    for shape in STENCIL3D_SHAPES:
        B = shape[0]
        u = torch.rand(shape, generator=g, device=dev) - 0.5
        row = {"phase": "kernels_K4_3d", "shape": list(shape),
               "tolerance": {"K4_atol": FIELD_ATOL}}
        for cb in dict.fromkeys((B, 1)):
            C = torch.rand((27, cb) + shape[1:], generator=g,
                           device=dev) - 0.5
            out = k4.apply_3d(C, u)
            ref = k4.stencil_apply_plain(C, u)
            torch.cuda.synchronize()
            e = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            row[f"C_batch_{cb}"] = {"max_abs_err": e, "rel_err": e / scale}
            err = max(err, e)
            if e > FIELD_ATOL * max(1.0, scale):
                fail(f"K4-3D at {row['shape']}, C batch {cb}: max abs err "
                     f"{e}")
            if shape == (1, 128, 128, 128):
                t = cuda_ms({"K4_3d_plain": lambda: k4.stencil_apply_plain(
                    C, u), "K4_3d": lambda: k4.apply_3d(C, u)})
                b = bound("stencil_apply_3d", (C, u, out), shape)
                times = dict(ms=t["K4_3d"], plain_ms=t["K4_3d_plain"], **b)
                row["ms"] = t
                row.update(b)
                row["kernel_GBps"] = b["bytes"] / (t["K4_3d"] * 1e-3) / 1e9
        emit(row)
    return {"err": err, "times": times}


# (B, n, anisotropic h, forcing): 1 x 2^2 and 1 x 97^2 hit K6's tile edges
# (31 node columns a warp); 1 x 129^2 is slice G1's grid; 8 x 256^2
# bench.py's NS shape (bench.py:1358), 8 x 512^2 its NS throughput shape
# (bench.py:1591-1601)
K6_SHAPES = ((2, 33, True, False), (2, 40, False, True), (2, 65, False, False),
             (1, 2, False, False), (1, 97, False, False),
             (1, 129, False, False), (8, 256, False, False),
             (8, 512, False, False))
K6_TIMED = ((8, 256), (8, 512))
# K6's row-block entry (the split route): (B, rows, nx, forcing) halo'd
# blocks of an nx^2 grid with its spacing. 129^2 over 4 ranks gives 33 and
# 34 rows (32 + 1, 32 + 2, 33 + 1), 35 the most a middle block of 33 would;
# 8 x 66 x 256 a middle block of 256 over 4, 2 x 9 x 32 of 32 over 4 (one
# tile row: fewer rows than a block's 4 ty - 1 at every strip); 1 x 2 x 65
# the least a block can be
K6_BLOCK_SHAPES = ((1, 33, 129, False), (1, 34, 129, False),
                   (1, 35, 129, False), (8, 66, 256, False),
                   (2, 9, 32, True), (1, 2, 65, False))


def phase_k6(dev) -> dict:
    """K6 against its plain version, each residual; times at 8 x 256^2 and
    8 x 512^2."""
    g = torch.Generator(device=dev).manual_seed(5)
    err, times = 0.0, {}
    visco = 0.01
    for B, n, aniso, with_f in K6_SHAPES:
        tb = basis_for(n, n, aniso, dev)
        u, v, p, fx, fy = (torch.rand((B, n, n), generator=g, device=dev)
                           for _ in range(5))
        if not with_f:
            fx = fy = None
        row = {"phase": "kernels_K6", "shape": [B, n, n], "forcing": with_f,
               "visco": visco, "tolerance": {"K6_atol": K6_ATOL}}
        R = k6.ns_vms_residual(u, v, p, fx, fy, tb, visco)
        Rp = k6.ns_vms_residual_plain(u, v, p, fx, fy, tb, visco)
        torch.cuda.synchronize()
        for name, a, b in zip(("R1", "R2", "R3"), R, Rp):
            e = float((a - b).abs().max())
            ref = float(b.abs().max())
            row[name] = {"max_abs_err": e, "rel_err": e / ref}
            err = max(err, e)
            if not e <= K6_ATOL * max(1.0, ref):
                fail(f"K6 {name} at {row['shape']}: max abs err {e}")
        if (B, n) in K6_TIMED:
            t = cuda_ms({"K6_plain": lambda: k6.ns_vms_residual_plain(
                u, v, p, None, None, tb, visco),
                "K6": lambda: k6.ns_vms_residual(u, v, p, None, None, tb,
                                                 visco)})
            b = bound("ns_vms_residual", (u, v, p) + tuple(R), (B, n, n))
            times[(B, n)] = dict(ms=t["K6"], plain_ms=t["K6_plain"], **b)
            row["ms"] = t
            row.update(b)
            row["kernel_GBps"] = b["bytes"] / (t["K6"] * 1e-3) / 1e9
            row["kernel_GFLOPps"] = b["operations"] / (t["K6"] * 1e-3) / 1e9
        emit(row)
        del u, v, p, fx, fy, R, Rp
    blocks = {}
    for B, ny, nx, with_f in K6_BLOCK_SHAPES:
        tb = basis_for(nx, nx, False, dev)
        u, v, p, fx, fy = (torch.rand((B, ny, nx), generator=g, device=dev)
                           for _ in range(5))
        if not with_f:
            fx = fy = None
        row = {"phase": "kernels_K6_block", "shape": [B, ny, nx],
               "grid": [nx, nx], "forcing": with_f, "visco": visco,
               "tolerance": {"K6_atol": K6_ATOL}}
        R = k6.ns_vms_residual(u, v, p, fx, fy, tb, visco, square=False)
        Rp = k6.ns_vms_residual_plain(u, v, p, fx, fy, tb, visco)
        torch.cuda.synchronize()
        for name, a, b in zip(("R1", "R2", "R3"), R, Rp):
            e = float((a - b).abs().max())
            ref = float(b.abs().max())
            row[name] = {"max_abs_err": e, "rel_err": e / ref}
            err = max(err, e)
            if not e <= K6_ATOL * max(1.0, ref):
                fail(f"K6 {name} at block {row['shape']}: max abs err {e}")
        t = cuda_ms({"K6_plain": lambda: k6.ns_vms_residual_plain(
            u, v, p, fx, fy, tb, visco),
            "K6": lambda: k6.ns_vms_residual(u, v, p, fx, fy, tb, visco,
                                             square=False)})
        b = bound("ns_vms_residual", (u, v, p) + tuple(R), (B, ny, nx))
        blocks["x".join(map(str, (B, ny, nx)))] = dict(
            ms=t["K6"], plain_ms=t["K6_plain"], **b)
        row["ms"] = t
        row.update(b)
        emit(row)
    # the global entry keeps JAX's square fields
    try:
        k6.ns_vms_residual(u, v, p, None, None, tb, visco)
    except ValueError:
        pass
    else:
        fail("K6: the global entry took non-square fields")
    del u, v, p, fx, fy, R, Rp
    return {"err": err, "times": times[(8, 512)], "by_shape": {
        f"{B}x{n}x{n}": v for (B, n), v in times.items()},
        "by_block_shape": blocks}


def phase_gradients(dev) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    n = 65
    tb = basis_for(n, n, True, dev)
    u, nu, f, w = (torch.rand((2, n, n), generator=g, device=dev)
                   for _ in range(4))
    nu = nu + 0.5
    bc = (torch.rand((n, n), generator=g, device=dev) > 0.8).float()
    out = {"phase": "gradients", "shape": [2, n, n], "atol": VJP_ATOL}

    def grads(fn, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        fn(*xs).backward()
        return [x.grad for x in xs]

    pairs = {
        "K1_du_dnu": (grads(lambda u, nu: (k1.poisson_stiffness_action(
            u, nu, tb) * w).sum(), u, nu),
            grads(lambda u, nu: (k1.stiffness_action_plain(u, nu, tb)
                                 * w).sum(), u, nu)),
        "K3_du": (grads(lambda u: k3.poisson_energy_fused(u, nu, f, tb), u),
                  grads(lambda u: k3.energy_plain(u, nu, f, tb), u)),
        "K2_du": (grads(lambda u: k2.poisson_resmin_loss_fused(
            u, nu, f, bc, tb), u),
            grads(lambda u: k2.resmin_loss_grad_plain(u, nu, f, bc, tb)[0],
                  u)),
    }
    for cb in (2, 1):   # C per sample, and C shared by the batch
        C = torch.rand((9, cb, n, n), generator=g, device=dev) - 0.5
        pairs[f"K4_dC_du_C_batch_{cb}"] = (
            grads(lambda C, u: (k4.stencil_apply(C, u) * w).sum(), C, u),
            grads(lambda C, u: (k4.stencil_apply_plain(C, u) * w).sum(),
                  C, u))
    # 3D at 17^3: K5 du/dnu, K4-3D dC/du
    n3 = 17
    tb3 = basis_3d((2, n3, n3, n3), True, dev)
    u3, nu3, w3 = (torch.rand((2, n3, n3, n3), generator=g, device=dev)
                   for _ in range(3))
    nu3 = nu3 + 0.5
    pairs["K5_du_dnu_17cubed"] = (
        grads(lambda u, nu: (k5.poisson_stiffness_action_3d(u, nu, tb3)
                             * w3).sum(), u3, nu3),
        grads(lambda u, nu: (k5.stiffness_action_3d_plain(u, nu, tb3)
                             * w3).sum(), u3, nu3))
    for cb in (2, 1):
        C = torch.rand((27, cb, n3, n3, n3), generator=g, device=dev) - 0.5
        pairs[f"K4_3d_dC_du_C_batch_{cb}_17cubed"] = (
            grads(lambda C, u: (k4.stencil_apply(C, u, 3) * w3).sum(),
                  C, u3),
            grads(lambda C, u: (k4.stencil_apply_plain(C, u) * w3).sum(),
                  C, u3))
    # K6 at 33^2 (anisotropic h): its VJP, and its JVP through
    # torch.func.jvp (the Jacobian action of the Newton-Krylov solve)
    n6, visco = 33, 0.01
    tb6 = basis_for(n6, n6, True, dev)
    uvp = [torch.rand((2, n6, n6), generator=g, device=dev)
           for _ in range(3)]
    tang = [torch.rand((2, n6, n6), generator=g, device=dev) - 0.5
            for _ in range(3)]
    w6 = [torch.rand((2, n6, n6), generator=g, device=dev) for _ in range(3)]

    def weighted(fn):
        return lambda u, v, p: sum((R * w).sum() for R, w in zip(
            fn(u, v, p, None, None, tb6, visco), w6))

    pairs["K6_vjp_33sq"] = (grads(weighted(k6.ns_vms_residual_fused), *uvp),
                            grads(weighted(k6.ns_vms_residual_plain), *uvp))
    pairs["K6_jvp_33sq"] = tuple(
        list(torch.func.jvp(lambda u, v, p, fn=fn: fn(
            u, v, p, None, None, tb6, visco), tuple(uvp), tuple(tang))[1])
        for fn in (k6.ns_vms_residual_fused, k6.ns_vms_residual_plain))
    torch.cuda.synchronize()
    for name, (got, ref) in pairs.items():
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        scale = max(1.0, max(float(b.abs().max()) for b in ref))
        out[name] = {"max_abs_err": err, "rel_err": err / scale}
        if err > VJP_ATOL * scale:
            fail(f"{name}: max abs err {err} (scale {scale})")
    emit(out)


def slice_a(dev) -> dict:
    n = 64
    ds = RectangleManufactured(n)
    ds.n_samples = 1
    m = Poisson2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=exact, forcing=forcing, mms_dirichlet=True,
                  fused_kernels=True)
    before = counts()
    t0 = time.perf_counter()
    opt = Trainer(max_epochs=80, optimizer="lbfgs", lbfgs_max_iter=10,
                  device=dev).fit(m).optimizer
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with torch.no_grad():
        u = m.network()[0]
        eL2, _, uex = m.calc_l2_err(u)
    rel = float(eL2 / uex)
    launches = since(before)
    out = {"phase": "slice_A", "grid": [n, n], "final_rel_l2": rel,
           "limit": L2_LIMIT, "jax_reference": 2.046e-4, "seconds": dt,
           **lbfgs_info(opt), "launches": launches}
    emit(out)
    if not (tuple(u.shape) == (n, n) and bool(torch.isfinite(u).all())):
        fail("slice A: the solution is not a finite 64x64 field")
    if not rel <= L2_LIMIT:
        fail(f"slice A: rel L2 {rel} > {L2_LIMIT}")
    if launches["poisson_stiffness_action"] <= 0:
        fail("slice A: K1 never launched")
    return launches


def _field_module(n, bs, loss_type, **kw):
    ds = RectangleManufactured(n)
    ds.n_samples = 10 * bs
    init = np.random.default_rng(0).random((n, n)).astype(np.float32)
    return Poisson2D(DirectField((n, n), init=init), ds, domain_size=n,
                     batch_size=bs, loss_type=loss_type,
                     exact_solution=exact, forcing=forcing,
                     mms_dirichlet=True, **kw)


def _train_10(m, dev) -> tuple[Trainer, float]:
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-3,
                 device=dev)
    t0 = time.perf_counter()
    tr.fit(m)
    torch.cuda.synchronize()
    return tr, time.perf_counter() - t0


def _check_losses(name, losses):
    if len(losses) != 10 or not all(math.isfinite(v) for v in losses):
        fail(f"{name}: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall: {losses}")


def slice_b(dev) -> dict:
    n, bs = 512, 32
    m = _field_module(n, bs, "resmin", fused_kernels=True,
                      fused_loss_grad=True)
    ref = _field_module(n, bs, "resmin").to(dev)   # unfused, same start
    inputs, frc = m.dataset[0]
    batch = tuple(torch.from_numpy(np.broadcast_to(a, (bs,) + a.shape)
                                   .copy()).to(dev) for a in (inputs, frc))
    with torch.no_grad():
        first_ref = float(ref.training_loss(batch))
    del ref, batch
    before = counts()
    tr, dt = _train_10(m, dev)
    launches = since(before)
    losses = tr.step_losses
    out = {"phase": "slice_B", "grid": [n, n], "batch": bs,
           "losses": losses, "first_loss_unfused": first_ref,
           "seconds": dt, "fit_steps_per_s": 10 / dt, "launches": launches}
    emit(out)
    _check_losses("slice B", losses)
    if launches["poisson_resmin_loss_grad"] != 10:
        fail(f"slice B: K2 launched {launches} times, not once a step")
    if abs(losses[0] - first_ref) > FIRST_LOSS_RTOL * abs(first_ref):
        fail(f"slice B: first loss {losses[0]} vs unfused {first_ref}")
    return launches


def slice_c(dev) -> dict:
    n, bs = 512, 32
    m = _field_module(n, bs, "energy", fused_kernels=True)
    before = counts()
    tr, dt = _train_10(m, dev)
    launches = since(before)
    out = {"phase": "slice_C", "grid": [n, n], "batch": bs,
           "losses": tr.step_losses, "seconds": dt,
           "fit_steps_per_s": 10 / dt, "launches": launches}
    emit(out)
    _check_losses("slice C", tr.step_losses)
    if launches["poisson_energy"] < 10 or \
            launches["poisson_stiffness_action"] < 10:
        fail(f"slice C: launches {launches}")
    return launches


class _VarNuInstance:
    """bench.py's solve instance: nu = exp(2g), a smooth ~54x-contrast
    coefficient, source (u = 1) on the left column, sink (u = 0) on the
    right, zero forcing."""

    def __init__(self, nu):
        m = nu.shape[0]
        b1 = np.zeros((m, m), np.float32)
        b1[:, 0] = 1
        b2 = np.zeros((m, m), np.float32)
        b2[:, -1] = 1
        self.inputs = np.stack([nu, b1, b2], -1).astype(np.float32)
        self.forcing = np.zeros((m, m, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def _solve_ms(solve, b) -> tuple[float, tuple, list[float]]:
    """One warm-up solve, then the median of 3 synchronised solves, in ms;
    with the last solve's result."""
    res = solve(b)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solve(b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), res, ms


def _device_idle_share(solve, b) -> dict:
    """One solve under torch.profiler: the summed device time of its
    kernels and copies against the synchronised wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the card's activity only: recording every CPU operation as well
    # cost ~25 s of post-processing on G1's 73k-kernel Newton iteration,
    # for the same device events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels and copies; not the annotations of user ranges (an
    # optimizer's step), which span kernels already counted
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    by_name: dict[str, float] = {}
    for e in dev_events:   # names cut to 80 characters before summing
        key = e.name[:80]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / wall_us,
            "device_events": len(dev_events),
            "top_ms": {k: v / 1e3 for k, v in top}}


def d_problem(n: int, dev):
    """bench.py's solve instance on n^2 nodes: the fine dataset, the level
    factory (coarse levels get the fine nu restricted), the fine inputs and
    forcing on `dev`, and the right-hand side b (numpy)."""
    x = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(x, x, indexing="xy")
    g = (np.cos(2 * np.pi * X) * np.cos(np.pi * Y)
         + 0.5 * np.sin(3 * np.pi * X * Y))
    nu = np.exp(2.0 * g / np.abs(g).max()).astype(np.float32)
    ds_fine = _VarNuInstance(nu)
    cache = {}

    def factory(m_n):
        # coarse levels carry unit nu: inputs_per_level="restrict" feeds
        # them the fine nu, restricted
        if m_n not in cache:
            ds = ds_fine if m_n == n else _VarNuInstance(
                np.ones((m_n, m_n), np.float32))
            cache[m_n] = Poisson2D(DirectField((m_n, m_n)), ds,
                                   domain_size=m_n, batch_size=1,
                                   loss_type="resmin")
        return cache[m_n]

    inputs = torch.from_numpy(ds_fine.inputs)[None].to(dev)
    forcing = torch.from_numpy(ds_fine.forcing)[None].to(dev)
    bc = np.zeros((n, n), np.float32)
    bc[:, [0, -1]] = 1.0
    b_np = np.where(bc > 0.5, 0.0, np.random.default_rng(0).standard_normal(
        (n, n))).astype(np.float32)
    return ds_fine, factory, inputs, forcing, b_np


def d_linear_op(module, inputs, forcing):
    """v -> R(v) - R(0) of `module` on the instance (inputs, forcing)."""
    n = inputs.shape[1]
    b0 = module.residual_for_field(
        torch.zeros((1, n, n), device=inputs.device), inputs, forcing)[0]

    def A(v):
        return module.residual_for_field(v[None], inputs, forcing)[0] - b0
    return A


def slice_d(dev) -> dict:
    """The MG-CG solve of bench.py's ``_solve_time``, in its three
    variants (see the module docstring)."""
    n, iters = SOLVE_GRID, SOLVE_ITERS
    ds_fine, factory, inputs, forcing, b_np = d_problem(n, dev)
    b = torch.from_numpy(b_np).to(dev)

    def linear_op(module):
        """v -> R(v) - R(0) of `module` on the fine instance."""
        return d_linear_op(module, inputs, forcing)

    def mg(**kw):
        return multigrid_preconditioner(factory, n, n_coarse=33,
                                        inputs_per_level="restrict",
                                        device=dev, **kw)

    def relres(A, u):
        return torch.linalg.vector_norm(A(u) - b) / torch.linalg.vector_norm(b)

    # every variant is also held to the element-path operator, which runs
    # no kernel: a kernel that is wrong in a consistent way would converge
    # on its own wrong operator
    A_plain = linear_op(factory(n).to(dev))
    out = {"phase": "slice_D", "grid": [n, n], "iters": iters,
           "limit": RELRES_LIMIT, "jax_reference_relres": 8.92e-6}
    variants = {}
    for name in ("D1", "D2", "D3"):
        before = counts()
        t0 = time.perf_counter()
        if name == "D1":     # plain stencil matvec on every level
            A = A_plain
            M, info = mg()
        elif name == "D2":   # fine level and outer matvec through K1
            A = linear_op(Poisson2D(DirectField((n, n)), ds_fine,
                                    domain_size=n, batch_size=1,
                                    loss_type="resmin",
                                    fused_kernels=True).to(dev))
            M, info = mg(fine_matvec=A)
        else:                # every assembled level and the outer CG: K4
            M, info = mg(stencil_kernel="cuda")
            Cf, defect = extract_verified(A_plain, (n, n), device=dev)
            if defect > 1e-4:
                fail(f"slice D3: fine-operator stencil defect {defect}")

            def A(v, Cf=Cf):
                return stencil_matvec(Cf, v, kernel="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def solve(b, A=A, M=M):
            u, _ = cg(A, b, tol=0.0, maxiter=iters, M=M)
            return u, relres(A, u)

        ms, (u, rel), all_ms = _solve_ms(solve, b)
        launches = since(before)
        rel_plain = float(relres(A_plain, u))
        row = {"relres": float(rel), "relres_plain_op": rel_plain,
               "setup_s": setup_s, "solve_ms": ms, "solve_ms_all": all_ms,
               "levels": info["levels"], "launches": launches,
               "profile": _device_idle_share(solve, b)}
        variants[name] = row
        emit({"phase": f"slice_{name}", **row})
        if not (tuple(u.shape) == (n, n) and bool(torch.isfinite(u).all())):
            fail(f"slice {name}: the solution is not a finite {n}x{n} field")
        for key in ("relres", "relres_plain_op"):
            if not row[key] <= RELRES_LIMIT:
                fail(f"slice {name}: {key} {row[key]} > {RELRES_LIMIT}")
    if variants["D2"]["launches"]["poisson_stiffness_action"] <= 0:
        fail("slice D2: K1 never launched")
    if variants["D3"]["launches"]["stencil_apply_2d"] <= 0:
        fail("slice D3: K4 never launched")
    out["variants"] = {k: {kk: v[kk] for kk in ("relres", "relres_plain_op",
                                                "setup_s", "solve_ms")}
                       for k, v in variants.items()}
    emit(out)
    return {k: v["launches"] for k, v in variants.items()}


def slice_e1(dev) -> dict:
    """examples/poisson_3d.py's MMS run at its default 17^3, through K5."""
    n = 17
    ds = CuboidManufactured(n)
    ds.n_samples = 1
    m = Poisson3D(DirectField((n,) * 3, init=np.zeros((n,) * 3)), ds,
                  domain_size=n, batch_size=1, loss_type="resmin",
                  exact_solution=ds.exact, forcing=ds.forcing_func,
                  mms_dirichlet=True, fused_kernels=True)
    before = counts()
    t0 = time.perf_counter()
    opt = Trainer(max_epochs=60, optimizer="lbfgs", lbfgs_max_iter=10,
                  device=dev).fit(m).optimizer
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    with torch.no_grad():
        u = m.network()[0]
        eL2, _, uex = m.calc_l2_err(u)
    rel = float(eL2 / uex)
    launches = since(before)
    emit({"phase": "slice_E1", "grid": [n] * 3, "final_rel_l2": rel,
          "limit": E1_LIMIT, "jax_reference": JAX_E1_REL_L2, "seconds": dt,
          **lbfgs_info(opt), "launches": launches})
    if not (tuple(u.shape) == (n,) * 3 and bool(torch.isfinite(u).all())):
        fail("slice E1: the solution is not a finite 17^3 field")
    if not rel <= E1_LIMIT:
        fail(f"slice E1: rel L2 {rel} > {E1_LIMIT}")
    if launches["poisson_stiffness_action_3d"] <= 0:
        fail("slice E1: K5 never launched")
    return launches


def _cube_module(n, bs, **kw):
    ds = CuboidManufactured(n)
    ds.n_samples = 10 * bs
    init = np.random.default_rng(0).random((n,) * 3).astype(np.float32)
    return Poisson3D(DirectField((n,) * 3, init=init), ds, domain_size=n,
                     batch_size=bs, loss_type="resmin",
                     exact_solution=ds.exact, forcing=ds.forcing_func,
                     mms_dirichlet=True, **kw)


def slice_e2(dev) -> dict:
    """10 Adam steps at 64^3 x 4 (the reference's voxel scale) through K5."""
    n, bs = 64, 4
    m = _cube_module(n, bs, fused_kernels=True)
    ref = _cube_module(n, bs).to(dev)   # the unfused et path, same start
    inputs, frc = m.dataset[0]
    batch = tuple(torch.from_numpy(np.broadcast_to(a, (bs,) + a.shape)
                                   .copy()).to(dev) for a in (inputs, frc))
    with torch.no_grad():
        first_ref = float(ref.training_loss(batch))
    del ref, batch
    before = counts()
    tr, dt = _train_10(m, dev)
    launches = since(before)
    losses = tr.step_losses
    emit({"phase": "slice_E2", "grid": [n] * 3, "batch": bs,
          "losses": losses, "first_loss_unfused": first_ref, "seconds": dt,
          "fit_steps_per_s": 10 / dt, "launches": launches})
    _check_losses("slice E2", losses)
    if launches["poisson_stiffness_action_3d"] < 20:
        fail(f"slice E2: K5 launched {launches} times, not twice a step")
    if abs(losses[0] - first_ref) > FIRST_LOSS_RTOL * abs(first_ref):
        fail(f"slice E2: first loss {losses[0]} vs unfused {first_ref}")
    return launches


def smooth_nu_3d(n: int, seed: int = 0) -> np.ndarray:
    """nu = exp(2g), g a sum of four seeded cosine modes scaled to
    max |g| = 1 (a contrast of up to e^4, about 55x), on [z, y, x] nodes.
    The same as scripts/torch_port_reference_3d.py's, which gives the JAX
    package's figure on this problem."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n)
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    g = np.zeros((n, n, n))
    for _ in range(4):
        kx, ky, kz = rng.integers(1, 4, size=3)
        px, py, pz = rng.uniform(0.0, 2 * np.pi, size=3)
        g += (rng.uniform(0.5, 1.0) * np.cos(np.pi * kx * X + px)
              * np.cos(np.pi * ky * Y + py) * np.cos(np.pi * kz * Z + pz))
    g /= np.abs(g).max()
    return np.exp(2.0 * g).astype(np.float32)


class _VarNuInstance3D:
    """Slice F's instance: source (u = 1) on the x = 0 face, sink (u = 0)
    on the x = 1 face, zero forcing."""

    def __init__(self, nu):
        n = nu.shape[0]
        b1 = np.zeros((n, n, n), np.float32)
        b1[:, :, 0] = 1
        b2 = np.zeros((n, n, n), np.float32)
        b2[:, :, -1] = 1
        self.inputs = np.stack([nu, b1, b2], -1).astype(np.float32)
        self.forcing = np.zeros((n, n, n, 1), np.float32)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.inputs, self.forcing


def slice_f(dev) -> dict:
    """The 129^3 MG-CG solve in its three variants (see the module
    docstring)."""
    n, iters = SOLVE_GRID_3D, SOLVE_ITERS
    nu = smooth_nu_3d(n)
    ds_fine = _VarNuInstance3D(nu)
    cache = {}

    def factory(m_n):
        if m_n not in cache:
            ds = ds_fine if m_n == n else _VarNuInstance3D(
                np.ones((m_n,) * 3, np.float32))
            cache[m_n] = Poisson3D(DirectField((m_n,) * 3), ds,
                                   domain_size=m_n, batch_size=1,
                                   loss_type="resmin")
        return cache[m_n]

    inputs = torch.from_numpy(ds_fine.inputs)[None].to(dev)
    forcing = torch.from_numpy(ds_fine.forcing)[None].to(dev)
    b_np = np.random.default_rng(0).standard_normal((n, n, n))
    b_np[:, :, [0, -1]] = 0.0
    b = torch.from_numpy(b_np.astype(np.float32)).to(dev)

    def linear_op(module):
        b0 = module.residual_for_field(torch.zeros((1, n, n, n), device=dev),
                                       inputs, forcing)[0]

        def A(v):
            return module.residual_for_field(v[None], inputs, forcing)[0] - b0
        return A

    def mg(**kw):
        return multigrid_preconditioner(factory, n, n_coarse=N_COARSE_3D,
                                        nsd=3, inputs_per_level="restrict",
                                        device=dev, **kw)

    def relres(A, u):
        return torch.linalg.vector_norm(A(u) - b) / torch.linalg.vector_norm(b)

    A_plain = linear_op(factory(n).to(dev))
    out = {"phase": "slice_F", "grid": [n] * 3, "iters": iters,
           "nu_contrast": float(nu.max() / nu.min()),
           "limit": RELRES_LIMIT_3D, "jax_reference_relres": JAX_F_RELRES}
    variants = {}
    for name in ("F1", "F2", "F3"):
        before = counts()
        t0 = time.perf_counter()
        if name == "F1":     # plain stencil matvec on every level
            A = A_plain
            M, info = mg()
        elif name == "F2":   # fine level and outer matvec through K5
            A = linear_op(Poisson3D(DirectField((n,) * 3), ds_fine,
                                    domain_size=n, batch_size=1,
                                    loss_type="resmin",
                                    fused_kernels=True).to(dev))
            M, info = mg(fine_matvec=A)
        else:                # every assembled level and the outer CG: K4-3D
            M, info = mg(stencil_kernel="cuda")
            Cf, defect = extract_verified(A_plain, (n,) * 3, device=dev)
            if defect > 1e-4:
                fail(f"slice F3: fine-operator stencil defect {defect}")

            def A(v, Cf=Cf):
                return stencil_matvec(Cf, v, kernel="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0

        def solve(b, A=A, M=M):
            u, _ = cg(A, b, tol=0.0, maxiter=iters, M=M)
            return u, relres(A, u)

        ms, (u, rel), all_ms = _solve_ms(solve, b)
        launches = since(before)
        rel_plain = float(relres(A_plain, u))
        row = {"relres": float(rel), "relres_plain_op": rel_plain,
               "setup_s": setup_s, "solve_ms": ms, "solve_ms_all": all_ms,
               "levels": info["levels"], "launches": launches,
               "profile": _device_idle_share(solve, b)}
        variants[name] = row
        emit({"phase": f"slice_{name}", **row})
        if not (tuple(u.shape) == (n,) * 3 and bool(torch.isfinite(u).all())):
            fail(f"slice {name}: the solution is not a finite {n}^3 field")
        for key in ("relres", "relres_plain_op"):
            if not row[key] <= RELRES_LIMIT_3D:
                fail(f"slice {name}: {key} {row[key]} > {RELRES_LIMIT_3D}")
        del M, A
    if variants["F2"]["launches"]["poisson_stiffness_action_3d"] <= 0:
        fail("slice F2: K5 never launched")
    if variants["F3"]["launches"]["stencil_apply_3d"] <= 0:
        fail("slice F3: K4-3D never launched")
    out["variants"] = {k: {kk: v[kk] for kk in ("relres", "relres_plain_op",
                                                "setup_s", "solve_ms")}
                       for k, v in variants.items()}
    emit(out)
    return {k: v["launches"] for k, v in variants.items()}


def ldc_module(n: int, fused: bool, network=None, batch_size: int = 1,
               **kw) -> NavierStokes:
    """The lid-driven cavity at Re = G1_RE on n^2 nodes: NSLDCDataset, the
    regularised lid of ldc_bcs, the mean-control pressure gauge. The same
    problem as scripts/torch_port_reference_flow.py's at n = G1_GRID."""
    ds = NSLDCDataset(domain_sizes=(n, n), Re=G1_RE)
    ds.n_samples = 1
    u_bc, v_bc, p_bc = ldc_bcs((n, n))
    return NavierStokes(network, ds, domain_size=n, batch_size=batch_size,
                        Re=G1_RE,
                        u_bc=u_bc, v_bc=v_bc, p_bc=p_bc, fused_kernels=fused,
                        **kw)


def midline_figures(u, v, p) -> dict:
    """The figures a solve is held to, from nodal [n, n] fields: as
    scripts/torch_port_reference_flow.py's."""
    m = u.shape[0] // 2
    return {"u_min_x05": float(u[:, m].min()),
            "v_min_y05": float(v[m, :].min()),
            "v_max_y05": float(v[m, :].max()),
            "p_min_y05": float(p[m, :].min()),
            "p_max_y05": float(p[m, :].max())}


def _lid_err(u: np.ndarray) -> float:
    x = np.linspace(0.0, 1.0, u.shape[1])
    return float(np.abs(u[-1] - (1.0 - 16.0 * (x - 0.5) ** 4)).max())


def slice_g1(dev) -> dict:
    """The Newton-Krylov LDC solve (see the module docstring): with K6 to
    convergence, and without it for one Newton step, whose |F| is held to
    the fused run's after its first step."""
    n = G1_GRID
    out = {"phase": "slice_G1", "grid": [n, n], "Re": G1_RE,
           "newton_iters": G1_NEWTON_ITERS, "jax_reference": JAX_G1,
           "midline_atol": MIDLINE_ATOL,
           "unfused_step1_rtol": G1_UNFUSED_STEP1_RTOL}
    m = ldc_module(n, True)
    before = counts()
    t0 = time.perf_counter()
    (u, v, p), info = ns_newton_solve(m, newton_iters=G1_NEWTON_ITERS,
                                      device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = since(before)
    figs = midline_figures(u, v, p)
    final_F = info["residual_history"][-1]
    row = {"final_F": final_F, "newton_steps": info["newton_iters"],
           "residual_history": info["residual_history"], **figs,
           "lid_max_err": _lid_err(u), "entry_point_s": first_s,
           "launches": launches}
    if not all(np.isfinite(a).all() and a.shape == (n, n)
               for a in (u, v, p)):
        fail(f"slice G1: the fields are not finite {n}x{n} arrays")
    if not final_F <= max(1e-6, 2.0 * JAX_G1["final_F"]):
        fail(f"slice G1: final |F| {final_F}")
    if not info["newton_iters"] <= JAX_G1["newton_steps"] + 2:
        fail(f"slice G1: {info['newton_iters']} Newton steps")
    for key, val in figs.items():
        if not abs(val - JAX_G1[key]) <= MIDLINE_ATOL:
            fail(f"slice G1: {key} {val} vs JAX {JAX_G1[key]}")
    if not row["lid_max_err"] <= LID_ATOL:
        fail(f"slice G1: lid error {row['lid_max_err']}")
    if launches["ns_vms_residual"] <= 0:
        fail("slice G1: K6 never launched")

    # the preconditioner setup apart: the solve's time is the entry point's
    # run less it (the script's time limit is shared by every slice, so
    # the solve is not run twice)
    inputs = torch.from_numpy(m.dataset[0][0])[None].to(dev)

    def F(f):
        R = m.mixed_residual({k: a[None] for k, a in f.items()}, inputs,
                             None)
        return {k: a[0] for k, a in R.items()}

    t0 = time.perf_counter()
    M = stokes_block_preconditioner(m, device=dev)
    torch.cuda.synchronize()
    row["setup_s"] = time.perf_counter() - t0
    row["solve_s"] = first_s - row["setup_s"]
    x0 = {k: torch.zeros((n, n), device=dev) for k in ("u", "v", "p")}
    # one Newton iteration (F, one GMRES direction, the line search)
    row["profile_one_newton_iteration"] = _device_idle_share(
        lambda x: newton_solve(F, x, M=M, newton_iters=1, device=dev), x0)
    out["G1_fused"] = row
    emit({"phase": "slice_G1_fused", **row})
    del M

    # without K6, one Newton step through the entry point
    m = ldc_module(n, False)
    before = counts()
    t0 = time.perf_counter()
    _, info = ns_newton_solve(m, newton_iters=1, device=dev)
    torch.cuda.synchronize()
    step1 = info["residual_history"][1]
    fused1 = row["residual_history"][1]
    unfused = {"newton_iters": 1, "residual_history":
               info["residual_history"], "step1_F": step1,
               "fused_step1_F": fused1,
               "step1_rel_diff": abs(step1 - fused1) / fused1,
               "entry_point_s": time.perf_counter() - t0,
               "launches": since(before)}
    out["G1_unfused"] = unfused
    emit({"phase": "slice_G1_unfused", **unfused})
    if not unfused["step1_rel_diff"] <= G1_UNFUSED_STEP1_RTOL:
        fail(f"slice G1: the unfused step-1 |F| {step1} vs the fused "
             f"{fused1}")
    if unfused["launches"]["ns_vms_residual"] != 0:
        fail("slice G1: the unfused solve launched K6")
    emit({"phase": "slice_G1", **{k: v for k, v in out.items()
                                  if not k.startswith("G1_")},
          "solve_s_fused": row["solve_s"]})
    return out["G1_fused"]["launches"]


def slice_g2(dev) -> dict:
    """examples/ns_ldc.py's training configuration at 64^2, through
    Trainer.fit and K6."""
    n = G2_GRID
    m = ldc_module(n, True, DirectField((n, n), init=np.zeros((n, n)),
                                        n_fields=3), loss_norm="squared")
    ref = ldc_module(n, False, DirectField((n, n), init=np.zeros((n, n)),
                                          n_fields=3),
                     loss_norm="squared").to(dev)
    batch = tuple(torch.from_numpy(a)[None].to(dev) for a in m.dataset[0])
    m.to(dev)
    with torch.no_grad():
        first = float(m.training_loss(batch))
        first_ref = float(ref.training_loss(batch))
    before = counts()
    t0 = time.perf_counter()
    opt = Trainer(max_epochs=G2_EPOCHS, optimizer="lbfgs", lbfgs_max_iter=10,
                  device=dev).fit(m).optimizer
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = since(before)
    # ZoomLBFGS's own count of its closure's evaluations, over all epochs
    evaluations = lbfgs_info(opt)["evaluations"]
    with torch.no_grad():
        final = float(m.training_loss(batch))
        u, v, p = (a[0].cpu().numpy() for a in m.apply_bcs(
            m.network(batch[0]), batch[0]))
    row = {"phase": "slice_G2", "grid": [n, n], "epochs": G2_EPOCHS,
           "first_loss": first, "first_loss_unfused": first_ref,
           "final_loss": final, "drop": final / first, "limit": G2_DROP,
           **lbfgs_info(opt), "seconds": dt,
           "lid_max_err": _lid_err(u), "launches": launches,
           **midline_figures(u, v, p)}
    emit(row)
    if not all(np.isfinite(a).all() for a in (u, v, p)):
        fail("slice G2: the fields are not finite")
    if abs(first - first_ref) > FIRST_LOSS_RTOL_FLOW * abs(first_ref):
        fail(f"slice G2: first loss {first} vs unfused {first_ref}")
    if not final < G2_DROP * first:
        fail(f"slice G2: loss {first} -> {final}")
    if not row["lid_max_err"] <= LID_ATOL:
        fail(f"slice G2: lid error {row['lid_max_err']}")
    if not launches["ns_vms_residual"] >= evaluations > 0:
        fail(f"slice G2: K6 launched {launches['ns_vms_residual']} times "
             f"in {evaluations} evaluations")
    return launches


def _ns_field_module(fused: bool) -> NavierStokes:
    """Slice G3's module: 8 x 256^2 LDC training from seeded random fields
    (the params)."""
    n = G3_GRID
    m = ldc_module(n, fused, DirectField((n, n), n_fields=3),
                   loss_norm="squared", batch_size=G3_BATCH)
    m.dataset.n_samples = 10 * G3_BATCH
    rng = np.random.default_rng(0)
    params = {f"field_{i}": torch.from_numpy(
        rng.random((n, n)).astype(np.float32)) for i in range(3)}
    m.network.load_state_dict(params)
    return m


def slice_g3(dev) -> dict:
    """10 Adam steps at 8 x 256^2 through Trainer.fit and K6."""
    n, bs = G3_GRID, G3_BATCH
    m = _ns_field_module(True)
    ref = _ns_field_module(False).to(dev)
    batch = _resident_batch(ref, bs, dev)
    with torch.no_grad():
        first_ref = float(ref.training_loss(batch))
    del ref, batch
    before = counts()
    tr, dt = _train_10(m, dev)
    launches = since(before)
    losses = tr.step_losses
    emit({"phase": "slice_G3", "grid": [n, n], "batch": bs,
          "losses": losses, "first_loss_unfused": first_ref, "seconds": dt,
          "fit_steps_per_s": 10 / dt, "launches": launches})
    _check_losses("slice G3", losses)
    if launches["ns_vms_residual"] != 10:
        fail(f"slice G3: K6 launched {launches['ns_vms_residual']} "
             "times, not once a step")
    if abs(losses[0] - first_ref) > FIRST_LOSS_RTOL_FLOW * abs(first_ref):
        fail(f"slice G3: first loss {losses[0]} vs unfused {first_ref}")
    return launches


class _EpochLosses(Callback):
    def __init__(self):
        self.losses = []

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses.append(metrics["loss"])


def _spread(rates) -> dict:
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "n": len(rates)}


def _heldout_scores(m, solver, items, free, tol, dev, name, **solve_kw):
    """Each held-out case of an IBN slice scored against the direct Krylov
    solve of its own immersed problem (the reference scripts' scoring):
    `m`'s field (BCs applied) on the card, `solver`'s module_linear_solve
    on the same inputs at `tol`; the rel L2 on the nodes `free` (a function
    of the inputs) marks and the energy gap under `m`'s loss; each solve's
    time and kernel launches. Returns the figures and, for each case,
    (u_net, u_ref, inputs, forcing)."""
    out = {"heldout_rel_l2": [], "heldout_energy_gap": [],
           "direct_solve_s": [], "solve_launches": []}
    cases = []
    for i, item in enumerate(items):
        batch = tuple(torch.from_numpy(a)[None].to(dev) for a in item)
        with torch.no_grad():
            u, inp, frc = m(batch)
            u_net = m.apply_bcs(u, inp)[0].cpu().numpy()
        inputs = inp[0].cpu().numpy()
        before = counts()
        t0 = time.perf_counter()
        u_ref, _ = module_linear_solve(
            solver, inputs_tensor=inputs, forcing_tensor=frc[0].cpu().numpy(),
            tol=tol, device=dev, **solve_kw)
        out["direct_solve_s"].append(time.perf_counter() - t0)
        out["solve_launches"].append(since(before))
        mask = free(inputs)
        out["heldout_rel_l2"].append(float(
            np.linalg.norm((u_net - u_ref)[mask])
            / np.linalg.norm(u_ref[mask])))
        with torch.no_grad():
            e_net, e_ref = (float(m.loss(torch.from_numpy(v)[None].to(dev),
                                         inp, frc)) for v in (u_net, u_ref))
        out["heldout_energy_gap"].append((e_net - e_ref) / e_ref)
        if not (np.isfinite(u_net).all() and np.isfinite(u_ref).all()):
            fail(f"{name}: held-out case {i}: fields not finite")
        cases.append((u_net, u_ref, inp, frc))
    out["heldout_rel_l2_mean"] = float(np.mean(out["heldout_rel_l2"]))
    out["heldout_energy_gap_mean"] = float(np.mean(
        out["heldout_energy_gap"]))
    return out, cases


def _ibn_export(net, chi, dev) -> dict:
    """export_forward -> save_exported -> load_exported of the trained AE
    at batch 1 and 64: the loaded program's output against the module's,
    and both latencies (CUDA events)."""
    out = {}
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for bs in (1, 64):
            x = chi[:bs].contiguous()
            path = save_exported(export_forward(net, x),
                                 os.path.join(tmp, f"ae_bs{bs}.pt2"))
            served = load_exported(path).module()
            with torch.no_grad():
                y, want = served(x), net(x)
                err = float((y - want).abs().max())
                scale = float(want.abs().max())
                ms = cuda_ms({"exported": lambda: served(x),
                              "module": lambda: net(x)})
            out[f"bs{bs}"] = {"max_abs_err": err,
                              "exported_ms": ms["exported"],
                              "module_ms": ms["module"],
                              "bytes": os.path.getsize(path)}
            if not (tuple(y.shape) == (bs, H_GRID, H_GRID, 1)
                    and err <= EXPORT_RTOL * max(1.0, scale)):
                fail(f"slice H: exported AE at batch {bs}: shape "
                     f"{tuple(y.shape)}, error {err}")
    return out


def _resident_profile(m, batch) -> dict:
    """Steps/s of `m` on a batch already on the card (three runs of 20
    Adam steps), then 10 steps under torch.profiler: device busy and wall
    ms a step, idle share, device operations, top operations."""
    out = {"resident_steps_per_s": _spread(
        [_resident_rate(m, batch) for _ in range(3)])}
    step = _adam_step(m, batch)
    for _ in range(3):
        step()
    prof = _device_idle_share(lambda _: [step() for _ in range(10)], None)
    out["resident_step_profile"] = {
        "steps": 10, "device_busy_ms_per_step": prof["device_busy_ms"] / 10,
        "wall_ms_per_step": prof["wall_ms"] / 10,
        "device_events_per_step": prof["device_events"] / 10, **prof}
    return out


def _h_network() -> AE:
    """Slice H's AE from the JAX reference's initial weights."""
    net = AE(1, 1, dims=8, n_downsample=2)
    net.load_state_dict(params_from_jax(seeded_params(flax_shapes(net),
                                                      H_INIT_SEED)))
    return net


def slice_h(dev, smi: str) -> dict:
    """The IBN flagship at the reference's width: winding-number chi from
    1,024 ellipse clouds, AE(dims=8, n_downsample=2), gpw Ritz energy,
    Adam 3e-4 with MultiStepLR, batches of 64, from the JAX reference's
    initial weights, through Trainer.fit; then the held-out accuracy
    against the direct solve, the resident step's rate and profile, and
    the export round trip."""
    ds = SyntheticPointClouds(n_samples=H_TRAIN, n_points=H_POINTS,
                              domain_size=H_GRID, seed=0)
    loader = NumpyLoader(ds, batch_size=H_BATCH, shuffle=True, device=dev)
    m = IBNPoisson2D(_h_network(),
                     domain_size=H_GRID, batch_size=H_BATCH,
                     learning_rate=H_LR)
    rec = _EpochLosses()
    tr = Trainer(max_epochs=H_EPOCHS, optimizer="adam", learning_rate=H_LR,
                 lr_milestones=H_MILESTONES, callbacks=[rec], device=dev)
    before = counts()
    t0 = time.perf_counter()
    tr.fit(m, loader)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = since(before)
    steps_a_epoch = len(loader)
    out = {"phase": "slice_H", "nvidia_smi": smi, "grid": [H_GRID, H_GRID],
           "batch": H_BATCH, "clouds": H_TRAIN, "points": H_POINTS,
           "epochs": H_EPOCHS, "steps": H_EPOCHS * steps_a_epoch,
           "fit_s": fit_s, "first_epoch_s": tr.epoch_times[0],
           # every epoch after the first (which builds cuDNN's plans)
           "fit_steps_per_s": _spread([steps_a_epoch / t
                                       for t in tr.epoch_times[1:]]),
           "first_epoch_loss": rec.losses[0],
           "last_epoch_loss": rec.losses[-1], "launches": launches,
           "jax_reference": JAX_H, "rel_l2_factor": H_REL_L2_FACTOR}
    if not (all(math.isfinite(v) for v in rec.losses)
            and rec.losses[-1] < rec.losses[0]):
        fail(f"slice H: epoch losses {rec.losses}")
    held = SyntheticPointClouds(n_samples=H_HELDOUT, n_points=H_POINTS,
                                domain_size=H_GRID, seed=H_HELDOUT_SEED)
    out.update(_heldout_scores(
        m, m, (held[i] for i in range(H_HELDOUT)),
        lambda inputs: inputs[..., 1] < 0.5, 1e-8, dev, "slice H")[0])

    # the same fit with the loader assembling two batches ahead on a
    # thread, for H_PREFETCH_EPOCHS epochs from the same start
    mp = IBNPoisson2D(_h_network(),
                      domain_size=H_GRID, batch_size=H_BATCH,
                      learning_rate=H_LR)
    trp = Trainer(max_epochs=H_PREFETCH_EPOCHS, optimizer="adam",
                  learning_rate=H_LR, lr_milestones=H_MILESTONES,
                  device=dev)
    trp.fit(mp, NumpyLoader(ds, batch_size=H_BATCH, shuffle=True,
                            device=dev, prefetch=2))
    out["fit_prefetch_steps_per_s"] = _spread(
        [steps_a_epoch / t for t in trp.epoch_times[1:]])

    # the resident step: one batch on the card, the winding number
    # computed every step as in training; on a copy, so the trained
    # module stays as fit left it
    batch = next(iter(NumpyLoader(ds, batch_size=H_BATCH, device=dev)))
    out.update(_resident_profile(copy.deepcopy(m), batch))
    with torch.no_grad():
        chi = m._chi(batch[0])
    out["export"] = _ibn_export(m.network, chi[:64], dev)
    emit(out)
    if not (out["heldout_rel_l2_mean"]
            <= H_REL_L2_FACTOR * JAX_H["heldout_rel_l2_mean"]):
        fail(f"slice H: held-out rel L2 {out['heldout_rel_l2_mean']} > "
             f"{H_REL_L2_FACTOR} x JAX's {JAX_H['heldout_rel_l2_mean']}")
    return launches


def _ibn3d_heldout(m, dev) -> tuple[dict, tuple]:
    """Slice I's held-out topologies through _heldout_scores: the direct
    solve is CG at tol I_SOLVE_TOL on a Poisson3D resmin module, u = 1 on
    chi and 0 on the box, whose every matvec is K5; the free nodes are
    chi < 0.5 and off the box. Each solve's CG iterations (its K5 launches
    less the four residuals solve_linear takes before the loop: b, the
    affinity probe's two and r0) must stay below maxiter, so the solve
    stopped at its tolerance; its true relative residual is reported.
    Returns the figures and the first case."""
    held = TopoDataset3D([synthesize_topology_3d(n=I_GRID, seed=s)
                          for s in I_HELDOUT_SEEDS], domain_size=I_GRID)
    solver = Poisson3D(domain_size=I_GRID, loss_type="resmin",
                       fused_kernels=True, bc1_value=1.0, bc2_value=0.0)
    maxiter = 10 * int((I_GRID**3) ** 0.5)   # solve_linear's default
    out, cases = _heldout_scores(
        m, solver, held,
        lambda inputs: (inputs[..., 1] < 0.5) & (inputs[..., 2] < 0.5),
        I_SOLVE_TOL, dev, "slice I", maxiter=maxiter)
    out["cg_maxiter"] = maxiter
    out["cg_iters"] = [n["poisson_stiffness_action_3d"] - 4
                       for n in out.pop("solve_launches")]
    out["true_relres"] = []
    for i, (_, u_ref, inp, frc) in enumerate(cases):
        with torch.no_grad():
            r0, r = (float(torch.linalg.vector_norm(solver.residual_for_field(
                torch.from_numpy(v)[None].to(dev), inp, frc)))
                for v in (np.zeros_like(u_ref), u_ref))
        out["true_relres"].append(r / r0)
        if not 0 < out["cg_iters"][i] < maxiter:
            fail(f"slice I: direct solve {i} ran {out['cg_iters'][i]} CG "
                 f"iterations of {maxiter}: it did not reach tol "
                 f"{I_SOLVE_TOL}")
    return out, cases[0]


def _mesh_check(m, case) -> dict:
    """surface_nets at level 0.5 of the trained network's field on a
    held-out topology, computed on the card, against that of the same
    weights' forward on the CPU. Where no node of the CPU's field lies
    within the two fields' largest difference (delta) of the level, both
    meshes have the same quads, and each vertex moves at most
    2 delta / g, g the least step of the field across a crossed grid edge
    (a crossing at t = fa / (fa - fb) moves by delta / |fa - fb| to first
    order). The OBJ written."""
    u_card, _, inp, _ = case
    net = copy.deepcopy(m.network).cpu()
    with torch.no_grad():
        u_cpu = m.apply_bcs(net(inp.cpu()), inp.cpu())[0].numpy()
    delta = float(np.abs(u_card - u_cpu).max())
    f = u_cpu - 0.5
    near = int((np.abs(f) <= delta).sum())
    gap = min([1.0] + [float(np.abs(d)[c].min()) for d, c in (
        (np.diff(f, axis=ax), np.diff(f < 0, axis=ax)) for ax in range(3))
        if c.any()])
    v, q = surface_nets(u_card, level=0.5)
    v_ref, q_ref = surface_nets(u_cpu, level=0.5)
    out = {"vertices": len(v), "quads": len(q), "cpu_vertices": len(v_ref),
           "cpu_quads": len(q_ref), "field_max_abs_diff": delta,
           "nodes_within_diff_of_level": near, "least_crossing_step": gap,
           "vertex_atol": 2 * delta / gap}
    if len(q) > 0 and near == 0 and np.array_equal(q, q_ref):
        out["vertex_max_abs_diff"] = float(np.abs(v - v_ref).max())
    if not (len(q) > 0 and (near > 0 or out.get(
            "vertex_max_abs_diff", math.inf) <= out["vertex_atol"])):
        fail(f"slice I: surface_nets of the card's field {out}")
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = field_to_obj(os.path.join(tmp, "u.obj"), u_card)
        out["obj_bytes"] = os.path.getsize(path)
    return out


def slice_i(dev, smi: str) -> dict:
    """The 3D IBN (reference IBN_3D.py) at JAX's UNet3D width: 64 synthetic
    bar-lattice topologies on 32^3 nodes, UNet3D(base_filters=16) on the
    (domain, chi, bc2) channels, the gpw Ritz energy, Adam 1e-3, batches
    of 8 through Trainer.fit; then the held-out accuracy against the
    direct solves through K5, the resident step's rate and profile, the
    peak memory, and a surface-nets mesh of the trained field. The network
    starts from the JAX reference's weights (I_INIT_SEED)."""
    ds = TopoDataset3D([synthesize_topology_3d(n=I_GRID, seed=s)
                        for s in range(I_TRAIN)], domain_size=I_GRID)
    loader = NumpyLoader(ds, batch_size=I_BATCH, shuffle=True, device=dev)
    net = UNet3D(3, 1, base_filters=I_FILTERS)
    net.load_state_dict(params_from_jax(seeded_params(flax_shapes(net),
                                                      I_INIT_SEED)))
    m = IBNPoisson3D(net, domain_size=I_GRID, batch_size=I_BATCH,
                     learning_rate=I_LR)
    rec = _EpochLosses()
    tr = Trainer(max_epochs=I_EPOCHS, optimizer="adam", learning_rate=I_LR,
                 callbacks=[rec], device=dev)
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    t0 = time.perf_counter()
    tr.fit(m, loader)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps_a_epoch = len(loader)
    out = {"phase": "slice_I", "nvidia_smi": smi, "grid": [I_GRID] * 3,
           "batch": I_BATCH, "base_filters": I_FILTERS,
           "parameters": sum(p.numel() for p in m.network.parameters()),
           "volumes": I_TRAIN, "epochs": I_EPOCHS,
           "steps": I_EPOCHS * steps_a_epoch, "fit_s": fit_s,
           "first_epoch_s": tr.epoch_times[0],
           "fit_steps_per_s": _spread([steps_a_epoch / t
                                       for t in tr.epoch_times[1:]]),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "first_epoch_loss": rec.losses[0],
           "last_epoch_loss": rec.losses[-1],
           "jax_reference": JAX_I, "rel_l2_factor": I_REL_L2_FACTOR}
    if not (all(math.isfinite(v) for v in rec.losses)
            and rec.losses[-1] < rec.losses[0]):
        fail(f"slice I: epoch losses {rec.losses}")
    held, case = _ibn3d_heldout(m, dev)
    out.update(held)
    out["launches"] = since(before)

    batch = next(iter(NumpyLoader(ds, batch_size=I_BATCH, device=dev)))
    out.update(_resident_profile(copy.deepcopy(m), batch))
    out["mesh"] = _mesh_check(m, case)
    emit(out)
    if not (out["heldout_rel_l2_mean"]
            <= I_REL_L2_FACTOR * JAX_I["heldout_rel_l2_mean"]):
        fail(f"slice I: held-out rel L2 {out['heldout_rel_l2_mean']} > "
             f"{I_REL_L2_FACTOR} x JAX's {JAX_I['heldout_rel_l2_mean']}")
    return out["launches"]


def _dgcnn_parts_ms(net, points) -> dict:
    """Forward device ms of DGCNN2D's neighbour searches (knn_indices on
    the points and on the first two edge convs' features) and of its three
    edge convs (each with its search), against a whole forward."""
    with torch.no_grad():
        x1 = net._edge_conv(points, 0)
        x2 = net._edge_conv(x1, 1)
        k = min(net.k, points.shape[1] - 1)
        return cuda_ms({
            "knn": lambda: [knn_indices(h, k) for h in (points, x1, x2)],
            "edge_convs": lambda: net._edge_conv(net._edge_conv(
                net._edge_conv(points, 0), 1), 2),
            "forward": lambda: net(points)}, reps=5)


def slice_h2(dev, smi: str) -> None:
    """The point-cloud inputs of IBNPoisson2D on slice H's clouds, batch
    and rate: DGCNN2D on the points (network_input='cloud') and
    ImmDiffLargeNormals on the points and normals ('cloud_normals'),
    H2_EPOCHS epochs each through Trainer.fit; losses finite and falling,
    steps/s through fit and resident, one profiled resident step, and for
    DGCNN2D the device time of its neighbour searches and edge convs."""
    ds = SyntheticPointClouds(n_samples=H_TRAIN, n_points=H_POINTS,
                              domain_size=H_GRID, seed=0)
    nets = {"dgcnn2d_cloud": (
                lambda: DGCNN2D(2, domain_size=H_GRID, k=H2_K,
                                lowest_size=H2_LOWEST, seed=0), "cloud"),
            "immdiff_large_normals": (
                lambda: ImmDiffLargeNormals(H_POINTS, out_size=H_GRID,
                                            seed=0), "cloud_normals")}
    out = {"phase": "slice_H2", "nvidia_smi": smi, "grid": [H_GRID, H_GRID],
           "batch": H2_BATCH, "clouds": H_TRAIN, "points": H_POINTS,
           "epochs": H2_EPOCHS}
    for name, (make, network_input) in nets.items():
        m = IBNPoisson2D(make(), domain_size=H_GRID, batch_size=H2_BATCH,
                         learning_rate=H_LR, network_input=network_input)
        loader = NumpyLoader(ds, batch_size=H2_BATCH, shuffle=True,
                             device=dev)
        rec = _EpochLosses()
        tr = Trainer(max_epochs=H2_EPOCHS, optimizer="adam",
                     learning_rate=H_LR, callbacks=[rec], device=dev)
        t0 = time.perf_counter()
        tr.fit(m, loader)
        torch.cuda.synchronize()
        res = {"network_input": network_input,
               "fit_s": time.perf_counter() - t0,
               "steps": H2_EPOCHS * len(loader),
               "fit_steps_per_s": _spread([len(loader) / t
                                           for t in tr.epoch_times[1:]]),
               "epoch_losses": rec.losses}
        if not (all(math.isfinite(v) for v in rec.losses)
                and rec.losses[-1] < rec.losses[0]):
            fail(f"slice H2 {name}: epoch losses {rec.losses}")
        batch = next(iter(NumpyLoader(ds, batch_size=H2_BATCH, device=dev)))
        res.update(_resident_profile(copy.deepcopy(m), batch))
        if network_input == "cloud":
            parts = _dgcnn_parts_ms(m.network, batch[0][..., 0:2])
            busy = res["resident_step_profile"]["device_busy_ms_per_step"]
            res["forward_parts_ms"] = parts
            res["knn_share_of_step"] = parts["knn"] / busy
            res["edge_conv_share_of_step"] = parts["edge_convs"] / busy
        out[name] = res
    emit(out)


def _klsum_direct_solves(query, dev) -> tuple[np.ndarray, dict]:
    """Slice J's held-out references: the first J_HELDOUT query instances
    solved by CG (module_linear_solve, tol J_SOLVE_TOL) on a Poisson2D
    resmin module whose every residual is K1 (64 nodes a side is no 2^k + 1
    grid, so no V-cycle). Each solve's CG iterations (its K1 launches less
    the four residuals solve_linear takes before the loop) must stay below
    maxiter; its true relative residual is reported."""
    solver = Poisson2D(domain_size=J_GRID, loss_type="resmin",
                       fused_kernels=True, bc1_value=1.0, bc2_value=0.0)
    maxiter = 10 * J_GRID   # solve_linear's default: 10 sqrt(nodes)
    refs, out = [], {"cg_iters": [], "true_relres": [], "solve_s": []}
    for i in range(J_HELDOUT):
        inputs, frc = query[i]
        before = counts()
        t0 = time.perf_counter()
        u_ref, _ = module_linear_solve(solver, inputs_tensor=inputs,
                                       forcing_tensor=frc, tol=J_SOLVE_TOL,
                                       maxiter=maxiter, device=dev)
        out["solve_s"].append(time.perf_counter() - t0)
        iters = since(before)["poisson_stiffness_action"] - 4
        inp, f = (torch.from_numpy(a)[None].to(dev) for a in (inputs, frc))
        with torch.no_grad():
            r0, r = (float(torch.linalg.vector_norm(solver.residual_for_field(
                torch.from_numpy(v)[None].to(dev), inp, f)))
                for v in (np.zeros_like(u_ref), u_ref))
        out["cg_iters"].append(iters)
        out["true_relres"].append(r / r0)
        if not (0 < iters < maxiter and np.isfinite(u_ref).all()):
            fail(f"slice J: direct solve {i} ran {iters} CG iterations of "
                 f"{maxiter}: it did not reach tol {J_SOLVE_TOL}")
        refs.append(u_ref)
    out["cg_maxiter"] = maxiter
    out["solve_s_total"] = sum(out.pop("solve_s"))
    return np.stack(refs), out


def _klsum_scores(m, query, refs, dev) -> dict:
    """The network's field (BCs applied) on each held-out instance against
    its direct solve: rel L2 on the free nodes (off the two Dirichlet
    walls) and the energy gap under the module's loss."""
    rel, gaps = [], []
    for i in range(J_HELDOUT):
        batch = tuple(torch.from_numpy(a)[None].to(dev) for a in query[i])
        with torch.no_grad():
            u, inp, frc = m(batch)
            u_net = m.apply_bcs(u, inp)[0].cpu().numpy()
            e_net, e_ref = (float(m.loss(torch.from_numpy(v)[None].to(dev),
                                         inp, frc)) for v in (u_net, refs[i]))
        inputs = query[i][0]
        free = (inputs[..., 1] < 0.5) & (inputs[..., 2] < 0.5)
        rel.append(float(np.linalg.norm((u_net - refs[i])[free])
                         / np.linalg.norm(refs[i][free])))
        gaps.append((e_net - e_ref) / abs(e_ref))
        if not np.isfinite(u_net).all():
            fail(f"slice J: held-out case {i}: the field is not finite")
    return {"heldout_rel_l2": rel, "heldout_energy_gap": gaps,
            "heldout_rel_l2_mean": float(np.mean(rel)),
            "heldout_energy_gap_mean": float(np.mean(gaps))}


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def slice_j(dev, smi: str) -> dict:
    """The parametric KL-sum UQ path at BASELINE.md's 64^2 width: 4,096
    Sobol KL samples made by the host library, GoodNetwork(filters=16)
    from the JAX reference's initial weights, the Ritz energy through K3
    (forward) and K1 (its VJP), batches of 32, Adam 3e-4 through
    Trainer.fit with checkpoints; then query_statistical over 256 query
    samples, 64 of them solved directly (K1), the held-out accuracy, the
    UQ mean and standard deviation against the Monte-Carlo ones of the
    direct solves, and the resident step's rate and profile."""
    start = counts()
    t0 = time.perf_counter()
    train = KLSumStochastic(sobol_coefficients(J_TRAIN, 6, seed=0),
                            domain_size=J_GRID)
    query = KLSumStochastic(sobol_coefficients(J_QUERY, 6,
                                               seed=J_QUERY_SEED),
                            domain_size=J_GRID)
    data_s = time.perf_counter() - t0
    net = GoodNetwork(in_dim=J_GRID, out_dim=J_GRID, in_channels=3,
                      filters=J_FILTERS)
    net.load_state_dict(params_from_jax(seeded_params(flax_shapes(net),
                                                      J_INIT_SEED)))
    m = Poisson2D(net, train, domain_size=J_GRID, batch_size=J_BATCH,
                  learning_rate=J_LR, loss_type="energy", bc1_value=1.0,
                  bc2_value=0.0, fused_kernels=True).to(dev)
    before = counts()
    refs, solves = _klsum_direct_solves(query, dev)
    solve_launches = since(before)
    untrained = _klsum_scores(m, query, refs, dev)["heldout_rel_l2_mean"]

    rec = _EpochLosses()
    loader = NumpyLoader(train, batch_size=J_BATCH, shuffle=True, device=dev)
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        tr = Trainer(max_epochs=J_EPOCHS, optimizer="adam",
                     learning_rate=J_LR, callbacks=[rec], run_dir=tmp,
                     checkpoint=True, device=dev)
        before = counts()
        t0 = time.perf_counter()
        tr.fit(m, loader)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = since(before)
        ckpt_files = sorted(os.listdir(tmp))
    steps_a_epoch = len(loader)
    out = {"phase": "slice_J", "nvidia_smi": smi, "grid": [J_GRID, J_GRID],
           "batch": J_BATCH, "filters": J_FILTERS, "samples": J_TRAIN,
           "parameters": sum(p.numel() for p in net.parameters()),
           "epochs": J_EPOCHS, "steps": J_EPOCHS * steps_a_epoch,
           "data_s": data_s, "fit_s": fit_s,
           "first_epoch_s": tr.epoch_times[0],
           "fit_steps_per_s": _spread([steps_a_epoch / t
                                       for t in tr.epoch_times[1:]]),
           "epoch_losses": rec.losses, "checkpoints": ckpt_files,
           "fit_launches": fit_launches, "solve_launches": solve_launches,
           **solves, "jax_reference": JAX_J,
           "rel_l2_factor": J_REL_L2_FACTOR,
           "untrained_heldout_rel_l2_mean": untrained}
    if not (all(math.isfinite(v) for v in rec.losses)
            and rec.losses[-1] < rec.losses[0]):
        fail(f"slice J: epoch losses {rec.losses}")
    if fit_launches["poisson_energy"] < out["steps"] or \
            fit_launches["poisson_stiffness_action"] < out["steps"]:
        fail(f"slice J: K3 / K1 not launched every step: {fit_launches}")
    out.update(_klsum_scores(m, query, refs, dev))
    mean, sdev, all_u = query_statistical(m, query, batch_size=J_BATCH,
                                          device=dev)
    out["uq_mean_rel_l2"] = _rel_l2(mean, refs.mean(0))
    out["uq_sdev_rel_l2"] = _rel_l2(sdev, refs.std(0))
    if not (all_u.shape == (J_QUERY, J_GRID, J_GRID)
            and np.isfinite(all_u).all()):
        fail(f"slice J: query fields {all_u.shape}, not all finite")

    batch = next(iter(NumpyLoader(train, batch_size=J_BATCH, device=dev)))
    out.update(_resident_profile(copy.deepcopy(m), batch))
    out["launches"] = since(start)
    emit(out)
    if not (out["heldout_rel_l2_mean"]
            <= J_REL_L2_FACTOR * JAX_J["heldout_rel_l2_mean"]):
        fail(f"slice J: held-out rel L2 {out['heldout_rel_l2_mean']} > "
             f"{J_REL_L2_FACTOR} x JAX's {JAX_J['heldout_rel_l2_mean']}")
    if not out["heldout_rel_l2_mean"] <= J_UNTRAINED_FACTOR * untrained:
        fail(f"slice J: held-out rel L2 {out['heldout_rel_l2_mean']} not "
             f"below {J_UNTRAINED_FACTOR} x the untrained {untrained}")
    return out["launches"]


class _SwitchFigures(Callback):
    """Slice K's figures at the optimizer switch (after the Adam phase)."""

    def __init__(self, switch: int):
        self.switch, self.figures = switch, None

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        if epoch + 1 == self.switch:
            self.figures = _rr_figures(module)


def _rr_figures(m) -> dict:
    """Each objective's loss at the parameters, the midline figures and
    the lid error of a slice K module (as the JAX reference script's)."""
    dev = next(m.parameters()).device
    batch = tuple(torch.from_numpy(a)[None].to(dev) for a in m.dataset[0])
    with torch.no_grad():
        losses = [float(m.objective_loss(i, batch)) for i in range(3)]
        u, v, p = (a[0].cpu().numpy() for a in m.apply_bcs(
            m.network(batch[0]), batch[0]))
    if not all(np.isfinite(a).all() for a in (u, v, p)):
        fail("slice K: the fields are not finite")
    return {"objective_losses": losses, **midline_figures(u, v, p),
            "lid_max_err": _lid_err(u)}


def _rr_check(name, got, ref, factor, atol, two_sided) -> None:
    for i, (a, b) in enumerate(zip(got["objective_losses"],
                                   ref["objective_losses"])):
        if not (a <= factor * b and (not two_sided or b <= factor * a)):
            fail(f"slice K {name}: objective {i} loss {a} vs JAX {b} "
                 f"(factor {factor})")
    for key in ("u_min_x05", "v_min_y05", "v_max_y05", "p_min_y05",
                "p_max_y05"):
        if not abs(got[key] - ref[key]) <= atol:
            fail(f"slice K {name}: {key} {got[key]} vs JAX {ref[key]}")
    if not got["lid_max_err"] <= LID_ATOL:
        fail(f"slice K {name}: lid error {got['lid_max_err']}")


def _k6_trace_launches(path: str) -> int:
    """K6 kernels in a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "ns_vms_kernel" in e.get("name", ""))


def slice_k(dev, smi: str) -> dict:
    """Round-robin NS training through K6 (the reference's
    e1_ns_ldc_resmin setup): the Re-100 lid-driven cavity at 64^2, a
    three-field DirectField from zeros, one optimizer per field residual
    (each scoped to its field), Adam with a milestone, then at K_SWITCH
    [LBFGS(u), LBFGS(v), Adam(p)] through OptimizerSwitch, checkpoints on
    (the full-tree round robin: each LBFGS runs over all three fields, its
    gradients its own field's, the others pinned after every update);
    the figures against JAX's at the switch and at the end. Then the exact
    resume: the same run split at K_EPOCHS / 2 (resume_from state.ckpt)
    lands on the unbroken run's fields. Last, K_PROFILED_EPOCHS more epochs
    of the unbroken run under the Trainer's profiler, whose trace must name
    the K6 launches."""
    n = K_GRID

    def module():
        return ldc_module(n, True, DirectField((n, n), init=np.zeros((n, n)),
                                               n_fields=3),
                          loss_norm="squared")

    def trainer(epochs, callbacks=(), **kw):
        return Trainer(max_epochs=epochs, optimizer="adam",
                       learning_rate=K_LR, lr_milestones=[K_MILESTONE],
                       round_robin=True, lbfgs_max_iter=K_LBFGS_ITERS,
                       callbacks=[OptimizerSwitch(K_SWITCH, K_SWITCH_TO),
                                  *callbacks], device=dev, **kw)

    start = counts()
    half = K_EPOCHS // 2
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        m = module()
        first = _rr_figures(m.to(dev))
        rec = _SwitchFigures(K_SWITCH)
        os.makedirs(os.path.join(tmp, "full"))
        tr = trainer(K_EPOCHS, [rec], run_dir=os.path.join(tmp, "full"),
                     checkpoint=True)
        before = counts()
        t0 = time.perf_counter()
        tr.fit(m)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = since(before)
        end = _rr_figures(m)
        adam_s = tr.epoch_times[1:K_SWITCH]
        lbfgs_s = [t for i, t in enumerate(tr.epoch_times)
                   if i >= K_SWITCH and (i - K_SWITCH) % 3 < 2]

        run1 = os.path.join(tmp, "half")
        os.makedirs(run1)
        m1 = module()
        trainer(half, run_dir=run1, checkpoint=True).fit(m1)
        m2 = module()
        trainer(K_EPOCHS - half).fit(
            m2, resume_from=os.path.join(run1, "state.ckpt"))
        # three epochs more of the unbroken run (LBFGS(u), LBFGS(v),
        # Adam(p)) under the Trainer's profiler
        tr3 = trainer(K_PROFILED_EPOCHS,
                      profile_dir=os.path.join(tmp, "prof"))
        before = counts()
        tr3.fit(module(), resume_from=os.path.join(tmp, "full",
                                                   "state.ckpt"))
        torch.cuda.synchronize()
        profiled_launches = since(before)["ns_vms_residual"]
        trace_launches = _k6_trace_launches(tr3.trace_path)
        trace_bytes = os.path.getsize(tr3.trace_path)
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(
            m.network.parameters(), m2.network.parameters()))
        scale = max(float(a.abs().max()) for a in m.network.parameters())
    out = {"phase": "slice_K", "nvidia_smi": smi, "grid": [n, n],
           "Re": G1_RE, "epochs": K_EPOCHS, "switch": K_SWITCH,
           "switch_to": K_SWITCH_TO, "lr": K_LR, "milestone": K_MILESTONE,
           "lbfgs": [lbfgs_info(o) for o in tr.state.optimizer[:2]],
           "fit_s": fit_s,
           "adam_epoch_ms": 1e3 * statistics.median(adam_s),
           "lbfgs_epoch_ms": 1e3 * statistics.median(lbfgs_s),
           "start": first, "at_switch": rec.figures, "end": end,
           "obj0_drop_at_switch": (first["objective_losses"][0]
                                   / rec.figures["objective_losses"][0]),
           "fit_launches": fit_launches, "resume_split": half,
           "resume_max_abs_diff": diff, "field_max_abs": scale,
           "profiled_epochs": K_PROFILED_EPOCHS,
           "profiled_k6_launches": profiled_launches,
           "trace_k6_launches": trace_launches, "trace_bytes": trace_bytes,
           "jax_reference": JAX_K, "launches": since(start)}
    emit(out)
    if not out["obj0_drop_at_switch"] >= K_DROP:
        fail(f"slice K: objective 0 fell {out['obj0_drop_at_switch']}x by "
             f"the switch, not {K_DROP}x")
    _rr_check("at the switch", rec.figures, JAX_K["at_switch"],
              K_SWITCH_FACTOR, K_SWITCH_MIDLINE_ATOL, two_sided=True)
    _rr_check("at the end", end, JAX_K["end"], K_END_FACTOR,
              K_END_MIDLINE_ATOL, two_sided=False)
    if not diff <= K_RESUME_ATOL * max(1.0, scale):
        fail(f"slice K: the resumed fields differ from the unbroken run's "
             f"by {diff}")
    if fit_launches["ns_vms_residual"] < K_EPOCHS:
        fail(f"slice K: K6 launched {fit_launches['ns_vms_residual']} "
             f"times in {K_EPOCHS} objective steps")
    if not 0 < trace_launches <= profiled_launches:
        fail(f"slice K: the profiler trace names {trace_launches} K6 "
             f"launches, the wrapper counted {profiled_launches}")
    return out["launches"]


# -- slice L: the single-instance physics ------------------------------------
# Each case at the grid of its JAX figure (CONVERGENCE.md, or the JAX
# package's own test), built from scripts/torch_port_reference_physics_cases.py
# as scripts/torch_port_reference_physics.py builds it; JAX_L holds the
# figures that script prints.
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "scripts"))
from torch_port_reference_physics_cases import (  # noqa: E402
    AC_GRID, AC_LINEAR, AC_NEWTON, ADV_A, ADV_EPOCHS, ADV_GRID,
    ADV_GRID_COARSE, ADV_NU, ADV_START_SCALES, AIRFOIL_EPOCHS,
    AIRFOIL_POINTS, BURGERS_EPOCHS, BURGERS_GRID, CIRCLE_POINTS,
    EIK_FDM_EPOCHS, EIK_FDM_POINTS, EIK_GRID, EIK_WEIGHTS, FDM_EPOCHS,
    FDM_GRID, GN, HEAT_EPOCHS, HEAT_GRID, HELM_EPOCHS, HELM_GRID,
    HELM_K12, HELM_K12_MAXITER, HELM_K12_TOL, LBFGS_ITERS, SKEW_EPOCHS,
    SKEW_GRID, SKEW_NU, SPHERE_GRID, SPHERE_POINTS, TWODOF_EPOCHS,
    TWODOF_GRID, BurgersMMS, ac_exact, ac_forcing, ac_frame,
    ac_linforcing, advdiff_exact, advdiff_forcing, advdiff_start,
    airfoil_control_polygon, airfoil_figures, burgers_exact,
    burgers_forcing, cloud_of, heat_exact_forcing, sdf_error)
L_MMS_FACTOR = 1.3     # MMS errors: at most 1.3x JAX's, as slice E1
L_SDF_FACTOR = 1.25    # SDF errors: at most 1.25x JAX's, as slices H, I
L_ITERS_SLACK = 2      # Newton and Gauss-Newton steps: at most JAX's + 2
#                        where JAX stopped below the step cap
L_FINAL_FACTOR = 1.3   # final loss or residual: at most 1.3x JAX's
SKEW_CENTRE_ATOL = 0.05
JAX_L = {   # scripts/torch_port_reference_physics.py, on a CPU
         "helmholtz_mms_rel_l2": 0.0006049238727428019,
         "helmholtz_k12_rel_l2": 3.2017800549510866e-05,
         "advdiff_mms_rel_l2": 0.0006445482140406966,
         "advdiff_mms_rel_l2_starts": [
             0.0006445482140406966, 0.0007918801275081933,
             0.0008782703662291169, 0.0009896422270685434],
         "advdiff_mms_coarse_rel_l2": 0.0026565827429294586,
         "skew_min": -0.11087954044342041,
         "skew_max": 1.0370718240737915,
         "skew_centre": 0.9588693380355835,
         "heat_rel_l2": 0.0006390105118043721,
         "allencahn_rel_l2": 0.00015034442185424268,
         "allencahn_newton_iters": 5,
         "allencahn_residual_history": [
             1.730250005493872e-05, 1.036364210449392e-05,
             1.0363602086727042e-05, 1.0363413821323775e-05,
             1.0362932698626537e-05, 1.0362809007347096e-05],
         "burgers_rel_l2": 5.0200098485220224e-05,
         "twodof_rel_l2": 0.0012025435142823868,
         "fdm_max_interior_err": 0.001042944229100895,
         "airfoil": {
             "mean_abs_u_cloud": 0.0028397856095779233,
             "h": 0.015873015873015872,
             "median_inside": -0.10000000149011612,
             "corner_00": 0.10000000149011612,
             "corner_11": 0.10000000149011612,
             "inside_nodes": 526},
         "circle_gn": {
             "sdf_err": 0.03729686331407118,
             "gn_iters": 40,
             "final_loss": 0.000657864089589566,
             "start_sdf_err": 0.050580684046932965},
         "sphere_gn": {
             "sdf_err": 0.03768868110295273,
             "gn_iters": 37,
             "final_loss": 29.531349182128906,
             "start_sdf_err": 0.05084137394328424},
         "eikonal_fdm": {
             "first_loss": 135.82620239257812,
             "last_loss": 1.3028171062469482}}


def _l_fit(m, epochs, dev, loader=None, callbacks=()):
    """An LBFGS fit (10 iterations a step): the trainer, wall s, ms an
    epoch."""
    tr = Trainer(max_epochs=epochs, optimizer="lbfgs",
                 lbfgs_max_iter=LBFGS_ITERS, callbacks=list(callbacks),
                 device=dev)
    t0 = time.perf_counter()
    tr.fit(m, loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return tr, wall, 1e3 * statistics.median(tr.epoch_times)


def _rel_l2_module(m, u) -> float:
    with torch.no_grad():
        eL2, _, uex = m.calc_l2_err(u)
    return float(eL2 / uex)


def _l_check(line: dict, key: str, ref: float, factor: float) -> None:
    """Hold figure `key` of a slice L line to factor x JAX's `ref`."""
    got = line[key]
    line[f"{key}_jax"] = ref
    line[f"{key}_limit"] = factor * ref
    if not (math.isfinite(got) and got <= factor * ref):
        fail(f"{line['phase']}: {key} {got} > {factor} x JAX's {ref}")


def _l_steps(what: str, got: int, ref: int, cap: int) -> None:
    """Hold a solver's step count to JAX's + L_ITERS_SLACK. Where JAX ran
    to the cap no count can exceed it, and the final loss or residual is
    the check."""
    if ref < cap and got > ref + L_ITERS_SLACK:
        fail(f"{what} took {got} steps, JAX {ref}")


def _l_emit(line: dict, checks) -> None:
    for args in checks:
        _l_check(line, *args)
    emit({**line, "optimizer": "zoom"})


def slice_l1(dev, smi: str) -> None:
    """Helmholtz: the k = 0.5 MMS by LBFGS (one epoch profiled) and the
    indefinite k = 12 MMS by GMRES through module_linear_solve."""
    n = HELM_GRID
    ds = RectangleHelmholtzManufactured(domain_size=n)
    ds.n_samples = 1
    m = Helmholtz2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                    domain_size=n, batch_size=1, exact_solution=ds.exact)
    _, wall, ms = _l_fit(m, HELM_EPOCHS, dev)
    mms = _rel_l2_module(m, m.network()[0])
    prof = _device_idle_share(lambda _: Trainer(
        max_epochs=1, optimizer="lbfgs", lbfgs_max_iter=LBFGS_ITERS,
        device=dev).fit(m), None)

    k = HELM_K12
    ds = RectangleHelmholtzManufactured(domain_size=n, khh=k)
    ds.n_samples = 1
    m = Helmholtz2D(DirectField((n, n)), ds, domain_size=n, batch_size=1,
                    khh=k, exact_solution=ds.exact,
                    forcing=lambda x, y: (2 * math.pi**2 - k**2) * np.sin(
                        math.pi * x) * np.sin(math.pi * y))
    t0 = time.perf_counter()
    u, _ = module_linear_solve(m, method="gmres", tol=HELM_K12_TOL,
                               maxiter=HELM_K12_MAXITER, device=dev)
    torch.cuda.synchronize()
    k12_s = time.perf_counter() - t0
    line = {"phase": "slice_L1", "nvidia_smi": smi, "grid": [n, n],
            "helmholtz_mms_rel_l2": mms, "epochs": HELM_EPOCHS,
            "wall_s": wall, "ms_per_lbfgs_epoch": ms,
            "lbfgs_epoch_profile": prof, "k12": k,
            "helmholtz_k12_rel_l2": _rel_l2_module(
                m, torch.from_numpy(u).to(dev)),
            "k12_gmres": {"tol": HELM_K12_TOL, "maxiter": HELM_K12_MAXITER},
            "k12_wall_s": k12_s}
    _l_emit(line, [("helmholtz_mms_rel_l2", JAX_L["helmholtz_mms_rel_l2"],
                    L_MMS_FACTOR),
                   ("helmholtz_k12_rel_l2", JAX_L["helmholtz_k12_rel_l2"],
                    L_MMS_FACTOR)])


def slice_l2(dev, smi: str) -> None:
    """SUPG advection-diffusion: the nu = 0.05 MMS at 33^2 from zeros and
    at 65^2 from zeros and three rounding-level starts (ADV_START_SCALES),
    then the inlet carried skew to the mesh. At 65^2 the error sits on
    float32's floor and spreads over starts that differ by rounding, in
    JAX as in the port, so the median of the four is held to 1.3x the
    median of JAX's four; 33^2, which does not spread, to 1.3x JAX's."""
    def mms(n, scale):
        ds = RectangleManufactured(n)
        ds.n_samples = 1
        m = AdvDiff2D(DirectField((n, n), init=advdiff_start(n, scale)), ds,
                      adv=ADV_A, diffusivity=ADV_NU, domain_size=n,
                      batch_size=1, forcing=advdiff_forcing,
                      exact_solution=advdiff_exact, bc1_value=0.0)
        _, wall, ms = _l_fit(m, ADV_EPOCHS, dev)
        return _rel_l2_module(m, m.network()[0]), wall, ms

    coarse, coarse_wall, _ = mms(ADV_GRID_COARSE, 0.0)
    starts = [mms(ADV_GRID, scale) for scale in ADV_START_SCALES]
    fine, wall, ms = starts[0]
    fine_starts = [r[0] for r in starts]
    n = ADV_GRID

    ns = SKEW_GRID
    ds = AdvDiff2dRectangle(domain_size=ns)
    ds.n_samples = 1
    m = AdvDiff2D(DirectField((ns, ns), init=np.zeros((ns, ns))), ds,
                  adv=ADV_A, diffusivity=SKEW_NU, domain_size=ns,
                  batch_size=1, bc1_value=1.0)
    _, skew_wall, skew_ms = _l_fit(m, SKEW_EPOCHS, dev)
    with torch.no_grad():
        u = m.apply_bcs(m.network(), torch.from_numpy(ds[0][0]).to(dev)[None]
                        )[0].cpu().numpy()
    centre = float(u[ns // 2, ns // 2])
    line = {"phase": "slice_L2", "nvidia_smi": smi, "grid": [n, n],
            "advdiff_mms_rel_l2": fine,
            "advdiff_mms_rel_l2_jax": JAX_L["advdiff_mms_rel_l2"],
            "start_scales": ADV_START_SCALES,
            "advdiff_mms_rel_l2_starts": fine_starts,
            "advdiff_mms_rel_l2_jax_starts": JAX_L[
                "advdiff_mms_rel_l2_starts"],
            "advdiff_mms_rel_l2_median": statistics.median(fine_starts),
            "starts_wall_s": sum(r[1] for r in starts),
            "coarse_grid": [ADV_GRID_COARSE] * 2,
            "advdiff_mms_coarse_rel_l2": coarse,
            "coarse_wall_s": coarse_wall, "epochs": ADV_EPOCHS,
            "wall_s": wall, "ms_per_lbfgs_epoch": ms, "skew_grid": [ns, ns],
            "skew_epochs": SKEW_EPOCHS, "skew_wall_s": skew_wall,
            "skew_ms_per_lbfgs_epoch": skew_ms, "skew_min": float(u.min()),
            "skew_max": float(u.max()), "skew_centre": centre,
            "skew_centre_jax": JAX_L["skew_centre"],
            "skew_centre_atol": SKEW_CENTRE_ATOL}
    _l_emit(line, [("advdiff_mms_coarse_rel_l2",
                    JAX_L["advdiff_mms_coarse_rel_l2"], L_MMS_FACTOR),
                   ("advdiff_mms_rel_l2_median",
                    statistics.median(JAX_L["advdiff_mms_rel_l2_starts"]),
                    L_MMS_FACTOR)])
    if not (np.isfinite(u).all() and -0.3 < u.min() and u.max() < 1.3
            and centre > 0.5):
        fail(f"slice L2: the skew field leaves its bounds: min {u.min()}, "
             f"max {u.max()}, centre {centre}")
    if not abs(centre - JAX_L["skew_centre"]) <= SKEW_CENTRE_ATOL:
        fail(f"slice L2: centre {centre} against JAX's "
             f"{JAX_L['skew_centre']}")


def slice_l3(dev, smi: str) -> None:
    """Space-time: heat by LBFGS, Allen-Cahn by the A = 0 linear solve and
    Newton-Krylov, Burgers (deg 2) by LBFGS."""
    n = HEAT_GRID
    ds = SpaceTimeRectangleManufactured(domain_size=n)
    ds.n_samples = 1
    ex, fo = heat_exact_forcing(ds)
    m = SpaceTimeHeat(DirectField((n, n), init=np.zeros((n, n))), ds,
                      domain_size=n, batch_size=1, exact_solution=ex,
                      forcing=fo, u0=ds.u0)
    _, heat_wall, heat_ms = _l_fit(m, HEAT_EPOCHS, dev)
    inputs = torch.from_numpy(ds[0][0]).to(dev)[None]
    with torch.no_grad():
        heat = _rel_l2_module(m, m.apply_bcs(m.network(), inputs)[0])

    n = AC_GRID
    ds = ac_frame(AllenCahnIceMeltRectangle(domain_size=n), n)
    inputs = torch.from_numpy(ds[0][0]).to(dev)[None]
    bc1, bc2 = inputs[..., 1], inputs[..., 2]
    m1 = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1, ac_A=0.0,
                          forcing=ac_linforcing, u0=ds.u0).to(dev)
    m = AllenCahnIceMelt(None, ds, domain_size=n, batch_size=1,
                         forcing=ac_forcing, exact_solution=ac_exact,
                         u0=ds.u0).to(dev)
    t0 = time.perf_counter()
    u_lin, _ = solve_linear(
        lambda u: m1.residual(m1.apply_bcs(u[None], inputs), bc1, bc2)[0],
        (n, n), device=dev, **AC_LINEAR)
    x, info = newton_solve(
        lambda u: m.residual(m.apply_bcs(u[None], inputs), bc1, bc2)[0],
        u_lin, device=dev, **AC_NEWTON)
    torch.cuda.synchronize()
    ac_wall = time.perf_counter() - t0
    with torch.no_grad():
        ac = _rel_l2_module(m, m.apply_bcs(x[None], inputs)[0])

    n = BURGERS_GRID
    ds = BurgersMMS(n)
    m = BurgersSpaceTime(DirectField((n, n), init=np.zeros((n, n))), ds,
                         domain_size=n, batch_size=1, forcing=burgers_forcing,
                         exact_solution=burgers_exact)
    _, bu_wall, bu_ms = _l_fit(m, BURGERS_EPOCHS, dev)
    inputs = torch.from_numpy(ds[0][0]).to(dev)[None]
    with torch.no_grad():
        burgers = _rel_l2_module(m, m.apply_bcs(m.network(), inputs)[0])
    line = {"phase": "slice_L3", "nvidia_smi": smi,
            "heat_grid": [HEAT_GRID] * 2, "heat_rel_l2": heat,
            "heat_epochs": HEAT_EPOCHS, "heat_wall_s": heat_wall,
            "heat_ms_per_lbfgs_epoch": heat_ms,
            "allencahn_grid": [AC_GRID] * 2, "allencahn_rel_l2": ac,
            "allencahn_newton_iters": info["newton_iters"],
            "allencahn_newton_iters_jax": JAX_L["allencahn_newton_iters"],
            "allencahn_residual_history": info["residual_history"],
            "allencahn_final_residual": info["residual_history"][-1],
            "allencahn_wall_s": ac_wall,
            "burgers_grid": [BURGERS_GRID] * 2, "burgers_rel_l2": burgers,
            "burgers_epochs": BURGERS_EPOCHS, "burgers_wall_s": bu_wall,
            "burgers_ms_per_lbfgs_epoch": bu_ms}
    _l_emit(line, [("heat_rel_l2", JAX_L["heat_rel_l2"],
                    L_MMS_FACTOR),
                   ("allencahn_rel_l2", JAX_L["allencahn_rel_l2"],
                    L_MMS_FACTOR),
                   ("burgers_rel_l2", JAX_L["burgers_rel_l2"],
                    L_MMS_FACTOR),
                   ("allencahn_final_residual",
                    JAX_L["allencahn_residual_history"][-1],
                    L_FINAL_FACTOR)])
    _l_steps("slice L3: Allen-Cahn", info["newton_iters"],
             JAX_L["allencahn_newton_iters"], AC_NEWTON["newton_iters"])


def slice_l4(dev, smi: str) -> None:
    """The strong forms: two-dof Poisson and FDM Poisson, by LBFGS."""
    n = TWODOF_GRID
    ds = RectangleManufactured(n)
    ds.n_samples = 1
    m = PoissonTwoDof2D(DirectField((n, n), init=np.zeros((n, n)),
                                    n_fields=3), ds, domain_size=n,
                        batch_size=1)
    _, tw_wall, tw_ms = _l_fit(m, TWODOF_EPOCHS, dev)
    batch = torch.from_numpy(ds[0][0]).to(dev)[None]
    with torch.no_grad():
        u = m.apply_bcs(m.network(batch), batch)[0][0].cpu().numpy()
    ue = RectangleManufactured.exact(ds.xx, ds.yy)
    twodof = float(np.linalg.norm(u - ue) / np.linalg.norm(ue))

    n = FDM_GRID
    ds = RectangleManufactured(n)
    ds.n_samples = 1
    m = PoissonFDM2D(DirectField((n, n), init=np.zeros((n, n))), ds,
                     domain_size=n, batch_size=1)
    _, fdm_wall, fdm_ms = _l_fit(m, FDM_EPOCHS, dev)
    with torch.no_grad():
        u = m.network()[0].cpu().numpy()
    fdm = float(np.abs(u - RectangleManufactured.exact(ds.xx, ds.yy))
                [1:-1, 1:-1].max())
    line = {"phase": "slice_L4", "nvidia_smi": smi,
            "twodof_grid": [TWODOF_GRID] * 2, "twodof_rel_l2": twodof,
            "twodof_epochs": TWODOF_EPOCHS, "twodof_wall_s": tw_wall,
            "twodof_ms_per_lbfgs_epoch": tw_ms, "fdm_grid": [n, n],
            "fdm_max_interior_err": fdm, "fdm_epochs": FDM_EPOCHS,
            "fdm_wall_s": fdm_wall, "fdm_ms_per_lbfgs_epoch": fdm_ms}
    _l_emit(line, [("twodof_rel_l2", JAX_L["twodof_rel_l2"],
                    L_MMS_FACTOR),
                   ("fdm_max_interior_err", JAX_L["fdm_max_interior_err"],
                    L_MMS_FACTOR)])


def _l_gn(cls, n, cloud_args, dev) -> dict:
    """A Gauss-Newton SDF solve of the cloud from its signed start: the
    figures, the steps and ms a step."""
    shape = (n,) * (2 if cls is Eikonal2D else 3)
    m = cls(None, None, domain_size=n, batch_size=1, **EIK_WEIGHTS)
    u0 = signed_occupancy_init(*(torch.from_numpy(a).to(dev)[None]
                                 for a in cloud_args), shape)[0]
    r = eikonal_gn_residual(m, cloud_of(*cloud_args)[None], device=dev)
    t0 = time.perf_counter()
    x, info = gauss_newton_solve(r, u0, device=dev, **GN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"grid": list(shape), "sdf_err": sdf_error(x.cpu().numpy()),
            "start_sdf_err": sdf_error(u0.cpu().numpy()),
            "gn_iters": info["gn_iters"],
            "final_loss": info["loss_history"][-1], "wall_s": wall,
            "ms_per_gn_iter": 1e3 * wall / max(1, info["gn_iters"])}


def slice_l5(dev, smi: str) -> None:
    """Eikonal: the airfoil by LBFGS, the circle and the sphere by
    Gauss-Newton, the FDM variant by LBFGS."""
    n = EIK_GRID
    pts, nrm, area = nurbs_curve(airfoil_control_polygon(),
                                 n_samples=AIRFOIL_POINTS)
    cloud = cloud_of(pts, nrm, area)
    ds = InMemoryDataset(cloud[None], np.zeros((1, n, n, 1), np.float32))
    targs = [torch.from_numpy(a).to(dev)[None] for a in (pts, nrm, area)]
    chi = occupancy_from_cloud(*targs, (n, n))[0].cpu().numpy()
    u0 = signed_occupancy_init(*targs, (n, n))[0].cpu().numpy()
    m = Eikonal2D(DirectField((n, n), init=u0), ds, domain_size=n,
                  batch_size=1, **EIK_WEIGHTS)
    _, af_wall, af_ms = _l_fit(m, AIRFOIL_EPOCHS, dev,
                               NumpyLoader(ds, batch_size=1))
    with torch.no_grad():
        airfoil = airfoil_figures(m.network()[0].cpu().numpy(), pts, chi)
    circle = _l_gn(Eikonal2D, n, sample_ellipse_cloud(
        n_points=CIRCLE_POINTS, center=(0.5, 0.5), radii=(0.25, 0.25)), dev)
    sphere = _l_gn(Eikonal3D, SPHERE_GRID, sample_sphere_cloud(
        n_points=SPHERE_POINTS, radius=0.25), dev)

    pts, nrm, area = sample_ellipse_cloud(n_points=EIK_FDM_POINTS,
                                          center=(0.5, 0.5),
                                          radii=(0.28, 0.18))
    ds = InMemoryDataset(cloud_of(pts, nrm, area)[None],
                         np.zeros((1, n, n, 1), np.float32))
    u0 = signed_occupancy_init(*(torch.from_numpy(a).to(dev)[None]
                                 for a in (pts, nrm, area)), (n, n))[0]
    m = EikonalFDM2D(DirectField((n, n), init=u0.cpu().numpy()), ds,
                     domain_size=n, batch_size=1, **EIK_WEIGHTS)
    rec = _EpochLosses()
    _, fdm_wall, fdm_ms = _l_fit(m, EIK_FDM_EPOCHS, dev,
                                 NumpyLoader(ds, batch_size=1), [rec])
    line = {"phase": "slice_L5", "nvidia_smi": smi,
            "airfoil": {**airfoil, "grid": [n, n], "points": AIRFOIL_POINTS,
                        "epochs": AIRFOIL_EPOCHS, "wall_s": af_wall,
                        "ms_per_lbfgs_epoch": af_ms},
            "airfoil_mean_abs_u": airfoil["mean_abs_u_cloud"],
            "circle_gn": circle, "circle_sdf_err": circle["sdf_err"],
            "circle_final_loss": circle["final_loss"],
            "sphere_gn": sphere, "sphere_sdf_err": sphere["sdf_err"],
            "sphere_final_loss": sphere["final_loss"],
            "gn": GN, "gn_iters_jax": {
                "circle": JAX_L["circle_gn"]["gn_iters"],
                "sphere": JAX_L["sphere_gn"]["gn_iters"]},
            "eikonal_fdm": {"grid": [n, n], "epochs": EIK_FDM_EPOCHS,
                            "first_loss": rec.losses[0],
                            "last_loss": rec.losses[-1],
                            "jax": JAX_L["eikonal_fdm"], "wall_s": fdm_wall,
                            "ms_per_lbfgs_epoch": fdm_ms}}
    _l_emit(line, [
        ("airfoil_mean_abs_u", JAX_L["airfoil"]["mean_abs_u_cloud"],
         L_SDF_FACTOR),
        ("circle_sdf_err", JAX_L["circle_gn"]["sdf_err"], L_SDF_FACTOR),
        ("sphere_sdf_err", JAX_L["sphere_gn"]["sdf_err"], L_SDF_FACTOR),
        ("circle_final_loss", JAX_L["circle_gn"]["final_loss"],
         L_FINAL_FACTOR),
        ("sphere_final_loss", JAX_L["sphere_gn"]["final_loss"],
         L_FINAL_FACTOR)])
    if not (airfoil["median_inside"] < 0 and airfoil["corner_00"] > 0
            and airfoil["corner_11"] > 0):
        fail(f"slice L5: the airfoil's sign structure is wrong: {airfoil}")
    for name, got in (("circle", circle), ("sphere", sphere)):
        _l_steps(f"slice L5: the {name}", got["gn_iters"],
                 JAX_L[f"{name}_gn"]["gn_iters"], GN["newton_iters"])
    if not rec.losses[-1] < rec.losses[0]:
        fail(f"slice L5: the FDM eikonal loss did not fall: {rec.losses}")


def slice_l(dev, smi: str) -> dict:
    """Slice L, the single-instance physics: no kernel of the table lies
    on it (the JAX package computes these losses with XLA)."""
    start = counts()
    t0 = time.perf_counter()
    for fn in (slice_l1, slice_l2, slice_l3, slice_l4, slice_l5):
        fn(dev, smi)
    return {"seconds": time.perf_counter() - t0, "launches": since(start)}


# -- slice M: the FSDT plate, the immersed Poisson instances, SIMP ---------
# Each case as scripts/torch_port_reference_topopt.py builds it from
# scripts/torch_port_reference_topopt_cases.py; JAX_M holds the figures
# that script prints (JAX_PLATFORMS=cpu python
# scripts/torch_port_reference_topopt.py).
from torch_port_reference_topopt_cases import (  # noqa: E402
    FSDT_EPOCHS, FSDT_GRID, IM_CASES, IM_EPOCHS, IM_GRID, IM_START_SCALES,
    TOPOPT_GRID, TOPOPT_OUTER, TOPOPT_VF, direct_solve, im_start,
    rel_l2_free, topopt_figures, topopt_problem)
M_FACTOR = 1.3          # M1 rel L2 and loss, M2 rel L2: at most 1.3x JAX's
M1_WALL_ATOL = 1e-6     # M1: |w| on the clamped walls
M3_FIRST_RTOL = 1e-4    # M3: the first state solve's compliance vs JAX's
M3_FINAL_FACTOR = 1.05  # M3: the final compliance at most 1.05x JAX's
JAX_M = {   # JAX_PLATFORMS=cpu python scripts/torch_port_reference_topopt.py
    "fsdt": {"rel_l2_w_free": 0.859133471083152,
             "last_loss": 8.144716048263945e-06,
             "centre_w": 1.643971562385559,
             "centre_w_direct": 14.299617338672393},
    # each path's median over IM_START_SCALES: XLA, and K3 (interpret mode)
    "immersed": {
        "RectangleIM": {"xla_median": 2.646460670440086e-06,
                        "k3_median": 9.168916919894561e-07},
        "RectangleIMBack": {"xla_median": 2.6065277027234935e-07,
                            "k3_median": 6.7646510515741e-07},
        "CircleIMBack": {"xla_median": 4.920666072563738e-07,
                         "k3_median": 3.301964332315241e-07},
        "LShaped": {"xla_median": 3.7453695090391287e-07,
                    "k3_median": 2.3506944865855357e-07}},
    "topopt": {"volume_fraction": 0.40000003576278687,
               "compliance_first": 2.6448404788970947,
               "compliance_last": 0.6248775720596313,
               "post10_max_over_min": 1.0146498306519325,
               "rho_std": 0.2704329192638397,
               "solid_share": 0.4658203125,
               "void_share": 0.251953125}}


def _port_resid(fn, inputs, forcing):
    """A float64 numpy residual ``z [F, n, n] -> [F, n, n]`` of the port's
    module function ``fn(fields, inputs, forcing)``, on the CPU: the
    operator of the direct solves."""
    inp = torch.from_numpy(inputs).double()[None]
    frc = torch.from_numpy(forcing).double()[None]

    def resid(z):
        with torch.no_grad():
            R = fn(tuple(torch.from_numpy(a)[None] for a in z), inp, frc)
        return np.stack([r[0].numpy() for r in R])
    return resid


def slice_m1(dev, smi: str) -> None:
    """The FSDT plate (examples/more_physics.py fsdt) by LBFGS, against the
    float64 direct solve of its discrete operator."""
    n = FSDT_GRID
    ds = ElasticFSDTDataset(domain_size=n)
    ds.n_samples = 1
    m = ElasticFSDT(DirectField((n, n), init=np.zeros((n, n)), n_fields=3),
                    ds, domain_size=n, batch_size=1, loss_norm="squared")
    rec = _EpochLosses()
    _, wall, ms = _l_fit(m, FSDT_EPOCHS, dev, callbacks=[rec])
    inputs, forcing = ds[0]
    batch = torch.from_numpy(inputs).to(dev)[None]
    with torch.no_grad():
        w = m.apply_bcs(m.network(batch), batch)[0][0].cpu().numpy()
    ref = ElasticFSDT(None, ds, domain_size=n, batch_size=1)
    t0 = time.perf_counter()
    z, free = direct_solve(_port_resid(ref.calc_residuals, inputs, forcing),
                           3, (n, n))
    walls = inputs[..., 3] > 0.5
    jx = JAX_M["fsdt"]
    line = {"phase": "slice_M1", "nvidia_smi": smi, "grid": [n, n],
            "epochs": FSDT_EPOCHS, "wall_s": wall,
            "ms_per_lbfgs_epoch": ms, "first_loss": rec.losses[0],
            "last_loss": rec.losses[-1],
            "fsdt_rel_l2_w_free": rel_l2_free(w, z[0], free[0]),
            "walls_max_abs_w": float(np.abs(w[walls]).max()),
            "centre_w": float(w[n // 2, n // 2]),
            "centre_w_jax": jx["centre_w"],
            "centre_w_direct": float(z[0, n // 2, n // 2]),
            "direct_solve_s": time.perf_counter() - t0}
    # a field far from the solve passes the first (JAX's figure is 0.86
    # after the example's 100 epochs: the plate is ill-conditioned); the
    # loss, 28x below its start in JAX, is what such a field fails
    _l_emit(line, [("fsdt_rel_l2_w_free", jx["rel_l2_w_free"], M_FACTOR),
                   ("last_loss", jx["last_loss"], M_FACTOR)])
    if not line["walls_max_abs_w"] < M1_WALL_ATOL:
        fail(f"slice M1: |w| {line['walls_max_abs_w']} on the walls")


def slice_m2(dev, smi: str) -> None:
    """The immersed Poisson single instances: Poisson2D's energy through K3
    (and K1 in its VJP) by LBFGS from zeros and three rounding-level starts,
    each against the float64 direct solve of its discrete system on the
    free nodes. The fits end on float32's floor, where a figure spreads
    over starts and over the JAX package's own two float32 paths of this
    loss (XLA and K3: up to 2.9x apart): each case's median over the starts
    is held to M_FACTOR x the larger of JAX's two medians over the same
    starts."""
    n = IM_GRID
    line = {"phase": "slice_M2", "nvidia_smi": smi, "grid": [n, n],
            "epochs": IM_EPOCHS, "start_scales": list(IM_START_SCALES),
            "cases": {}}
    checks = []
    for name in IM_CASES:
        ds = getattr(single_instances, name)(domain_size=n)
        ds.n_samples = 1
        inputs, forcing = ds[0]
        ref = Poisson2D(None, ds, domain_size=n, batch_size=1)
        z, free = direct_solve(_port_resid(
            lambda f, i, fo: (ref.residual_for_field(f[0], i, fo),),
            inputs, forcing), 1, (n, n))
        batch = torch.from_numpy(inputs).to(dev)[None]
        figs, walls, ms = [], [], []
        before = counts()
        for scale in IM_START_SCALES:
            m = Poisson2D(DirectField((n, n), init=im_start(n, scale)), ds,
                          domain_size=n, batch_size=1, fused_kernels=True)
            _, wall, epoch_ms = _l_fit(m, IM_EPOCHS, dev)
            with torch.no_grad():
                u = m.apply_bcs(m.network(batch), batch)[0].cpu().numpy()
            figs.append(rel_l2_free(u, z[0], free[0]))
            walls.append(wall)
            ms.append(epoch_ms)
        launches = since(before)
        jx = JAX_M["immersed"][name]
        key = f"{name}_rel_l2_free_median"
        line[key] = statistics.median(figs)
        line["cases"][name] = {
            "rel_l2_free_starts": figs, "jax_xla_median": jx["xla_median"],
            "jax_k3_median": jx["k3_median"], "wall_s": walls,
            "ms_per_lbfgs_epoch": statistics.median(ms),
            "free_nodes": int(free.sum()), "launches": launches}
        checks.append((key, max(jx["xla_median"], jx["k3_median"]),
                       M_FACTOR))
        if launches["poisson_energy"] <= 0:
            fail(f"slice M2: {name}: K3 never launched")
    _l_emit(line, checks)


def slice_m3(dev, smi: str) -> dict:
    """SIMP topology optimisation by ``TopOpt2D.optimize``: every CG matvec
    through K1."""
    inputs, forcing = topopt_problem()
    m = TopOpt2D(None, None, domain_size=TOPOPT_GRID, batch_size=1,
                 target_vf=TOPOPT_VF, compliance_form="variational")
    before = counts()
    t0 = time.perf_counter()
    rho, _, hist = m.optimize(inputs, forcing, n_outer=TOPOPT_OUTER,
                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = since(before)["poisson_stiffness_action"]
    with torch.no_grad():
        figs = topopt_figures(m.project_density(rho).cpu().numpy(), hist)
    jx = JAX_M["topopt"]
    line = {"phase": "slice_M3", "nvidia_smi": smi,
            "grid": [TOPOPT_GRID] * 2, "n_outer": TOPOPT_OUTER, **figs,
            "jax": jx,
            "first_rel_diff": abs(figs["compliance_first"]
                                  / jx["compliance_first"] - 1.0),
            "wall_s": wall, "ms_per_outer_iteration": 1e3 * wall
            / TOPOPT_OUTER, "k1_launches": k1,
            # a solve's launches: one a CG iteration and one for r0
            "cg_iterations_per_solve": k1 / TOPOPT_OUTER - 1}
    emit(line)
    failed = [k for k, ok in figs["criteria"].items() if not ok]
    if failed:
        fail(f"slice M3: the JAX test's criteria {failed} fail: {figs}")
    if not line["first_rel_diff"] <= M3_FIRST_RTOL:
        fail(f"slice M3: first compliance {figs['compliance_first']} vs "
             f"JAX {jx['compliance_first']}")
    if not (figs["compliance_last"]
            <= M3_FINAL_FACTOR * jx["compliance_last"]):
        fail(f"slice M3: final compliance {figs['compliance_last']} > "
             f"{M3_FINAL_FACTOR} x JAX's {jx['compliance_last']}")
    if k1 <= 0:
        fail("slice M3: K1 never launched")
    return line


def slice_m(dev, smi: str, paths: dict) -> dict:
    """Slice M on two paths, each with its counts set to 0 first and read
    after: ``physics_2d_immersed`` (M1, no kernel; M2, K3 and K1) and
    ``topopt_2d`` (M3, K1). Returns the launches of M2 and M3."""
    t0 = time.perf_counter()
    reset_counts()
    slice_m1(dev, smi)
    slice_m2(dev, smi)
    paths["physics_2d_immersed"] = counts()
    reset_counts()
    slice_m3(dev, smi)
    paths["topopt_2d"] = counts()
    return {"seconds": time.perf_counter() - t0,
            "M2": paths["physics_2d_immersed"], "M3": paths["topopt_2d"]}


# Slice N, the multi-device path (diffnet_tpu_torch.parallel): a process
# group of N_WORLD ranks. With a card a rank it is NCCL, one rank a card;
# with fewer cards (one card, say) the ranks share cuda:0 over gloo,
# the halo rows and all-reduces through host memory, the compute on the
# card. The choice is by device count and is printed (backend, world).
# Tolerances, sharded against unsharded on the same card:
N_WORLD = 4
N_GRID, N_BATCH = 512, 32   # bench.py's grid (513 rows do not split in 4)
N_K1_SHAPES = ((1, N_GRID, N_GRID), (N_BATCH, N_GRID, N_GRID))
N_K5_SHAPE = (1, 128, 128, 128)   # the kernel table's K5 shape
N_CG_ITERS = 50
# The split CG solve sums each inner product in another order (4 partial
# sums, all-reduced): after 50 fixed iterations its iterate within
# N_CG_ATOL x max(1, max |x|) of the unsplit solve's and its relative
# residual within N_CG_RELRES_RTOL of it. slice_n on the CPU at full size
# (plain K1): 1.2e-6 of max |x| and 4e-6 relative.
N_CG_ATOL = 2e-5
N_CG_RELRES_RTOL = 1e-4
N3_LOSS_RTOL = 1e-5   # N3's losses against one process: the K2 batch sum
#                       in another order (4 partial sums; on the CPU 9.5e-8)
N_RANK_TIMEOUT = 600.0


def first_step_grads(module, fit) -> dict:
    """``fit()``, recording the gradients of `module`'s network as the
    first optimizer step begins (the all-reduced ones over a data mesh)."""
    grads = {}

    def hook(opt, args, kwargs):
        if not grads:
            grads.update({k: p.grad.detach().cpu().numpy().copy()
                          for k, p in module.network.named_parameters()})

    handle = register_optimizer_step_pre_hook(hook)
    try:
        fit()
    finally:
        handle.remove()
    return grads


def _rank_fields(shape, dev, seed=11):
    """u, nu, g of `shape` on `dev`, the same on every rank (seeded)."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand(shape, generator=gen)
    nu = torch.rand(shape, generator=gen) + 0.5
    g = torch.rand(shape, generator=gen) - 0.5
    return u.to(dev), nu.to(dev), g.to(dev)


def _host_ms(fn, reps=20, warmup=3) -> float:
    """Wall ms a call of `fn` (a collective, on every rank at once), host
    clock around `reps` calls after `warmup`, the card synchronised."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync()
    return (time.perf_counter() - t0) / reps * 1e3


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _n3_fit(dev, mesh=None) -> dict:
    """Slice B's 512^2 x 32 resmin (K2), 10 Adam steps through Trainer.fit:
    one process on the whole batch, or this rank's rows over `mesh`, the
    loader slice B's fit builds (shuffled, seed 42)."""
    m = _field_module(N_GRID, N_BATCH, "resmin", fused_kernels=True,
                      fused_loss_grad=True)
    loader = NumpyLoader(m.dataset, batch_size=N_BATCH, shuffle=True,
                         seed=42, device=dev, mesh=mesh)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-3,
                 device=dev)
    before = counts()
    t0 = time.perf_counter()
    tr.fit(m, loader)
    _sync()
    dt = time.perf_counter() - t0
    return {"losses": tr.step_losses, "fit_s": dt,
            "launches": since(before)}


def _n_cg(resfn, shape, dev, mesh=None):
    """N_CG_ITERS CG iterations (tol 0: every one runs) from zeros; the
    iterate and its relative residual."""
    x, _ = solve_linear(resfn, shape, tol=0.0, maxiter=N_CG_ITERS,
                        x0=torch.zeros(shape, device=dev), device=dev,
                        mesh=mesh)
    with torch.no_grad():
        r2, b2 = (resfn(x) ** 2).sum(), (resfn(torch.zeros_like(x)) ** 2).sum()
        if mesh is not None:
            r2, b2 = mesh.all_reduce(r2, "space"), mesh.all_reduce(b2, "space")
    return x, float((r2 / b2).sqrt())


def _n_cg_problem(dev):
    """The 512^2 N1 problem: walls Dirichlet, nu from the N1 fields, a
    seeded random load off the walls."""
    _, nu, _ = _rank_fields((1, N_GRID, N_GRID), dev)
    bc = torch.zeros((N_GRID, N_GRID), device=dev)
    bc[[0, -1], :] = 1.0
    bc[:, [0, -1]] = 1.0
    gen = torch.Generator().manual_seed(12)
    b = torch.randn((N_GRID, N_GRID), generator=gen).to(dev)
    return nu[0], bc, torch.where(bc > 0.5, 0.0, b)


def _err(got, want) -> dict:
    return {"max_abs_err": float((got - want).abs().max()),
            "scale": float(want.abs().max())}


N_SIZES = ("N_GRID", "N_BATCH", "N_K1_SHAPES", "N_K5_SHAPE", "N_CG_ITERS")


def slice_n_rank(rank: int, world: int, device: str, sizes: dict) -> dict:
    """Slice N on one rank of the group: N1 and N2 (the spatial K1 and K5
    path, launches counted), their references and times, N3 (the
    data-parallel fit). `sizes`: the parent's N_SIZES (a rank imports
    this script afresh, so a rehearsal's smaller sizes reach it so)."""
    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(dist.get_backend(), device)
    mesh = make_mesh(data=1, space=world)
    dmesh = make_mesh(data=world)
    out = {"rank": rank, "device": str(dev)}

    # N1 and N2 on the path: counts from 0, read after
    reset_counts()
    got = {}
    for shape in N_K1_SHAPES:
        u, nu, _ = _rank_fields(shape, dev)
        tb = basis_for(shape[1], shape[2], False, dev)
        got[shape] = poisson_stiffness_spatial_fused(
            *(local_block(t, mesh, 1, "space").contiguous()
              for t in (u, nu)), tb, mesh)
    tb = basis_for(N_GRID, N_GRID, False, dev)
    nu, bc, b = _n_cg_problem(dev)
    nu_l, bc_l, b_l = (local_block(t, mesh, 0, "space").contiguous()
                       for t in (nu, bc, b))

    def resfn_l(x):
        K = poisson_stiffness_spatial_fused(x[None].contiguous(),
                                            nu_l[None], tb, mesh)[0]
        return torch.where(bc_l > 0.5, 0.0, K) - b_l

    x_l, relres = _n_cg(resfn_l, tuple(b_l.shape), dev, mesh)
    u, nu3, g = _rank_fields(N_K5_SHAPE, dev)
    tb3 = basis_3d(N_K5_SHAPE, False, dev)
    u_l, nu3_l = (local_block(t, mesh, 1, "space").contiguous()
                  .requires_grad_(True) for t in (u, nu3))
    R5 = poisson_stiffness_spatial_fused_3d(u_l, nu3_l, tb3, mesh)
    (R5 * local_block(g, mesh, 1, "space")).sum().backward()
    _sync()
    out["spatial_launches"] = counts()

    # references, not counted: the unsharded kernels' rows
    errs = {}
    for shape in N_K1_SHAPES:
        u, nu_, _ = _rank_fields(shape, dev)
        tb_ = basis_for(shape[1], shape[2], False, dev)
        errs["k1 %dx%dx%d" % shape] = _err(got[shape], local_block(
            k1.stiffness_action(u, nu_, tb_), mesh, 1, "space"))

    def resfn(x):
        K = k1.stiffness_action(x[None].contiguous(), nu[None], tb)[0]
        return torch.where(bc > 0.5, 0.0, K) - b

    x_ref, relres_ref = _n_cg(resfn, (N_GRID, N_GRID), dev)
    errs["cg_iterate"] = _err(x_l, local_block(x_ref, mesh, 0, "space"))
    out["cg_relres"], out["cg_relres_unsharded"] = relres, relres_ref
    u, nu3, g = (t.requires_grad_(True) for t in _rank_fields(N_K5_SHAPE,
                                                               dev))
    R5_ref = poisson_stiffness_action_3d(u, nu3, tb3)
    (R5_ref * g.detach()).sum().backward()
    errs["k5 1x128^3"] = _err(R5.detach(), local_block(R5_ref.detach(),
                                                       mesh, 1, "space"))
    errs["k5 vjp du"] = _err(u_l.grad, local_block(u.grad, mesh, 1, "space"))
    errs["k5 vjp dnu"] = _err(nu3_l.grad, local_block(nu3.grad, mesh, 1,
                                                      "space"))
    out["errs"] = errs

    # times: the spatial call (exchange and kernel) against the kernel on
    # the already halo'd block, every rank at once on the shared card
    times = {}
    with torch.no_grad():
        for shape in N_K1_SHAPES + (N_K5_SHAPE,):
            u, nu_, _ = _rank_fields(shape, dev)
            fused = (poisson_stiffness_spatial_fused if len(shape) == 3
                     else poisson_stiffness_spatial_fused_3d)
            kern = (k1.stiffness_action if len(shape) == 3
                    else k5.stiffness_action_3d)
            tb_ = (basis_for(shape[1], shape[2], False, dev)
                   if len(shape) == 3 else tb3)
            ul, nul = (local_block(t, mesh, 1, "space").contiguous()
                       for t in (u, nu_))
            ub, nub = (halo_exchange(t, mesh, 1, 1, zero_edges=False)
                       .contiguous() for t in (ul, nul))
            name = "x".join(map(str, shape))
            kname = ("poisson_stiffness_action" if len(shape) == 3
                     else "poisson_stiffness_action_3d")
            b = bound(kname, (ub, nub, ub), tuple(ub.shape))
            times[name] = {
                "spatial_ms": _host_ms(lambda: fused(ul, nul, tb_, mesh)),
                "kernel_on_block_ms": _host_ms(lambda: kern(ub, nub, tb_)),
                # the kernel's bound on this rank's halo'd block
                "block_shape": list(ub.shape),
                "block_bound_ms": b["bound_ms"],
                "block_bound_by": b["bound_by"]}
    out["times"] = times

    # N3: the data-parallel fit
    reset_counts()
    out["n3"] = _n3_fit(dev, dmesh)
    flat = torch.zeros(N_GRID * N_GRID + 1, device=dev)
    out["n3"]["allreduce_ms"] = _host_ms(
        lambda: dmesh.all_reduce(flat, "data"))
    out["path_launches"] = {k: out["spatial_launches"][k]
                            + out["n3"]["launches"][k]
                            for k in KERNELS}
    return out


def _n_check_errs(name: str, ranks: list, atol: float) -> dict:
    """The largest error of each comparison over the ranks; fail if one
    exceeds ``atol * max(1, scale)``."""
    worst = {}
    for key in ranks[0]["errs"]:
        e = max(r["errs"][key]["max_abs_err"] for r in ranks)
        scale = max(r["errs"][key]["scale"] for r in ranks)
        worst[key] = {"max_abs_err": e, "scale": scale}
        if key == "cg_iterate":
            continue
        if not e <= atol * max(1.0, scale):
            fail(f"{name}: {key} is {e} off the unsharded kernel's "
                 f"(scale {scale})")
    return worst


def slice_n(dev, smi: str) -> dict:
    """Slice N, the multi-device path: the single-process references on the
    card, then one group of N_WORLD ranks (slice_n_rank), then
    dryrun_multigpu(N_WORLD). Returns the ranks' launches on the path,
    summed."""
    t0 = time.perf_counter()
    world = N_WORLD
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ref3 = _n3_fit(dev)
    unsharded_ms = {}
    for shape in N_K1_SHAPES + (N_K5_SHAPE,):
        name = "x".join(map(str, shape))
        kern = "poisson_stiffness_action" + ("_3d" if len(shape) == 4
                                             else "")
        unsharded_ms[name] = cuda_ms({name: _kernel_call(kern, shape, dev)}
                                     )[name]
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_ranks(slice_n_rank, world,
                      (dev.type, {k: globals()[k] for k in N_SIZES}),
                      backend=backend, timeout=N_RANK_TIMEOUT, threads=2)
    ranks_s = time.perf_counter() - t_ranks
    r0 = ranks[0]
    head = {"nvidia_smi": smi, "backend": backend, "world": world,
            "device_count": torch.cuda.device_count(),
            "devices": [r["device"] for r in ranks]}
    emit({"phase": "slice_N", **head, "ranks_s": ranks_s,
          "spatial_launches_by_rank": [r["spatial_launches"]
                                       for r in ranks]})

    errs = _n_check_errs("slice N", ranks, FIELD_ATOL)
    times = {}
    for name, t in r0["times"].items():
        times[name] = dict(t, unsharded_ms=unsharded_ms[name],
                           halo_share=1.0 - t["kernel_on_block_ms"]
                           / t["spatial_ms"])
    cg = errs["cg_iterate"]
    relres = [r["cg_relres"] for r in ranks]
    emit({"phase": "slice_N1", **head, "shapes": [list(s) for s in
                                                  N_K1_SHAPES],
          "errs": {k: v for k, v in errs.items() if k.startswith("k1")},
          "cg_iters": N_CG_ITERS, "cg_iterate": cg, "cg_atol": N_CG_ATOL,
          "cg_relres": relres[0], "cg_relres_unsharded":
              r0["cg_relres_unsharded"], "cg_relres_rtol": N_CG_RELRES_RTOL,
          "times": {k: v for k, v in times.items() if k.count("x") == 2},
          "k1_launches_by_rank": [r["spatial_launches"][
              "poisson_stiffness_action"] for r in ranks]})
    if not cg["max_abs_err"] <= N_CG_ATOL * max(1.0, cg["scale"]):
        fail(f"slice N1: the split CG iterate is {cg['max_abs_err']} off "
             "the unsharded one's")
    if len(set(relres)) != 1 or abs(relres[0] - r0["cg_relres_unsharded"]) \
            > N_CG_RELRES_RTOL * r0["cg_relres_unsharded"]:
        fail(f"slice N1: relres {relres} against unsharded "
             f"{r0['cg_relres_unsharded']}")
    emit({"phase": "slice_N2", **head, "shape": list(N_K5_SHAPE),
          "errs": {k: v for k, v in errs.items() if k.startswith("k5")},
          "times": {k: v for k, v in times.items() if k.count("x") == 3},
          "k5_launches_by_rank": [r["spatial_launches"][
              "poisson_stiffness_action_3d"] for r in ranks]})
    for r in ranks:
        for name in ("poisson_stiffness_action",
                     "poisson_stiffness_action_3d"):
            if r["spatial_launches"][name] <= 0:
                fail(f"slice N: rank {r['rank']} never launched {name}")

    n3 = [r["n3"] for r in ranks]
    rel3 = max(abs(a - b) / abs(b) for a, b in zip(n3[0]["losses"],
                                                   ref3["losses"]))
    emit({"phase": "slice_N3", **head, "grid": [N_GRID, N_GRID],
          "batch": N_BATCH, "rows_a_rank": N_BATCH // world,
          "losses": n3[0]["losses"], "losses_one_process": ref3["losses"],
          "max_rel_diff": rel3, "rtol": N3_LOSS_RTOL,
          "fit_s_by_rank": [r["fit_s"] for r in n3],
          "fit_s_one_process": ref3["fit_s"],
          "allreduce_ms": n3[0]["allreduce_ms"],
          "allreduce_floats": N_GRID * N_GRID + 1,
          "k2_launches_by_rank": [r["launches"]["poisson_resmin_loss_grad"]
                                  for r in n3]})
    _check_losses("slice N3", n3[0]["losses"])
    for r in n3:
        if r["launches"]["poisson_resmin_loss_grad"] != 10:
            fail(f"slice N3: K2 launched {r['launches']} times on a rank, "
                 "not once a step")
        if r["losses"] != n3[0]["losses"]:
            fail("slice N3: the ranks logged different losses")
    if not rel3 <= N3_LOSS_RTOL:
        fail(f"slice N3: losses {rel3} off the one-process run's")

    t_dry = time.perf_counter()
    dry = dryrun_multigpu(world, device=dev.type, threads=2)
    emit({"phase": "slice_N_dryrun", **head, **dry,
          "seconds": time.perf_counter() - t_dry})
    emit({"phase": "slice_N_done", "seconds": time.perf_counter() - t0})
    return {k: sum(r["path_launches"][k] for r in ranks) for k in KERNELS}


# -- slice O: the split solvers, the split NS residual, root-norm losses ----
# Four paths over O_WORLD ranks (as slice N: gloo with the ranks sharing the
# card where there are fewer cards than ranks), each held to one process
# on the same card: O1 slice D's 513^2 54x-contrast MG-CG (D3's variant: K4
# on every assembled level and the outer matvec) with the rows split over
# 'space'; O2 slice G1's 129^2 Re-100 cavity residual (mean-control gauge)
# on row blocks, through K6's row-block entry and without it; O3 one
# restart cycle of split GMRES on that residual's Jacobian action; O4 G3's
# 8 x 256^2 cavity with the Frobenius loss (a root of a sum over the
# batch), data-parallel over 'data' = O_WORLD, 2 rows a rank.
O_WORLD = 4
O_GRID, O_ITERS, O_COARSE = SOLVE_GRID, SOLVE_ITERS, 33   # slice D's
O_NS_GRID = G1_GRID
O_GMRES = {"tol": 0.0, "restart": 10, "maxiter": 1}
O4_STEPS = 2
# Tolerances, split against one process on the same card:
O1_ATOL = 2e-5          # the MG-CG iterate, x max(1, max |x|) (as N1's CG);
#                         the relres within slice D's RELRES_LIMIT, under
#                         the split operator and the element path's (it
#                         sits near float32's floor, where rounding moves
#                         it: 1.64e-6 split, 1.72e-6 whole at 65^2 on the
#                         CPU, with iterates 3e-7 of max |x| apart)
O3_RTOL = 1e-4          # the GMRES direction, x max |dx|: ten Arnoldi steps
#                         from all-reduced projections (on the CPU 6e-6 of
#                         max |dx| at 32^2, and float32's own GMRES iterate
#                         5e-5 of max |x| from its float64 run)
O4_LOSS_RTOL = 1e-5     # O4's losses; its gradient of step 1 within
O4_GRAD_RTOL = 1e-5     # O4_GRAD_RTOL of its largest entry
O_SIZES = ("O_GRID", "O_ITERS", "O_COARSE", "O_NS_GRID", "G3_GRID",
           "G3_BATCH", "O4_STEPS")


def _o1_solve(dev, mesh=None) -> dict:
    """Slice D's MG-CG in D3's variant, whole or with the rows split over
    `mesh`: the iterate (this rank's rows), its relres under its own
    operator and under the element path's, the setup s and the split
    operator (for the times)."""
    n = O_GRID
    ds_fine, factory, inputs, forcing, b_np = d_problem(n, dev)
    t0 = time.perf_counter()
    M, info = multigrid_preconditioner(
        factory, n, n_coarse=O_COARSE, inputs_per_level="restrict",
        stencil_kernel="cuda", device=dev, mesh=mesh)
    A_plain = d_linear_op(factory(n).to(dev), inputs, forcing)
    Cf, defect = extract_verified(A_plain, (n, n), device=dev)
    if defect > 1e-4:
        fail(f"slice O1: fine-operator stencil defect {defect}")
    b = torch.from_numpy(b_np).to(dev)
    if mesh is None:
        def A(v):
            return stencil_matvec(Cf, v, kernel="cuda")
    else:
        A = SplitStencil(local_block(Cf, mesh, 1, "space"), mesh,
                         kernel="cuda")
        b = local_block(b, mesh, 0, "space").contiguous()
    _sync()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, _ = cg(A, b, tol=0.0, maxiter=O_ITERS, M=M, mesh=mesh)
    _sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        r2, b2 = ((A(x) - b) ** 2).sum(), (b ** 2).sum()
        if mesh is not None:
            r2, b2 = (mesh.all_reduce(t, "space") for t in (r2, b2))
        x_all = x if mesh is None else gather_block(x, mesh, 0, n=n)
        b_all = torch.from_numpy(b_np).to(dev)
        rel_plain = float(torch.linalg.vector_norm(A_plain(x_all) - b_all)
                          / torch.linalg.vector_norm(b_all))
    return {"x": x, "relres": float((r2 / b2).sqrt()),
            "relres_plain_op": rel_plain, "setup_s": setup_s,
            "solve_ms": solve_ms, "levels": info["levels"],
            "split_levels": info["split_levels"], "A": A, "M": M, "b": b}


def _o_fields(n, dev):
    """O2 and O3's state: seeded cavity fields (one sample), as the JAX
    package's spatial test draws its (tests/test_parallel.py:167-168)."""
    rng = np.random.default_rng(13)
    return [torch.from_numpy((rng.random((1, n, n)) * 0.1).astype(
        np.float32)).to(dev) for _ in range(3)]


def _o_residual(m, fields, inputs, mesh=None):
    """The mean-control mixed residual of (u, v, p), stacked."""
    R = m.mixed_residual(dict(zip("uvp", fields)), inputs, None, mesh)
    return torch.stack([R[k] for k in "uvp"])


def _o3_gmres(m, fields, inputs, mesh=None):
    """O_GMRES's cycle of GMRES on the Jacobian action at `fields`
    (torch.func.jvp through the residual), its right-hand side -F: one
    Newton direction."""
    x = torch.stack(fields)

    def F(y):
        return _o_residual(m, list(y.unbind(0)), inputs, mesh)

    def Jv(v):
        return torch.func.jvp(F, (x,), (v,))[1]

    with torch.no_grad():
        rhs = -F(x)
    return gmres(Jv, rhs, mesh=mesh, **O_GMRES)[0]


def _o4_fit(dev, mesh=None) -> dict:
    """G3's 8 x 256^2 cavity fields with the Frobenius loss, O4_STEPS Adam
    steps through Trainer.fit and K6: one process on the whole batch, or
    this rank's rows of it over `mesh`; the losses and step 1's
    gradient."""
    n, bs = G3_GRID, G3_BATCH
    m = ldc_module(n, True, DirectField((n, n), n_fields=3),
                   loss_norm="frobenius", batch_size=bs)
    m.dataset.n_samples = O4_STEPS * bs
    rng = np.random.default_rng(0)
    m.network.load_state_dict({f"field_{i}": torch.from_numpy(
        rng.random((n, n)).astype(np.float32)) for i in range(3)})
    loader = NumpyLoader(m.dataset, batch_size=bs, shuffle=True, seed=42,
                         device=dev, mesh=mesh)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=1e-3,
                 device=dev)
    t0 = time.perf_counter()
    grads = first_step_grads(m, lambda: tr.fit(m, loader))
    _sync()
    return {"losses": tr.step_losses, "grad_first": grads,
            "fit_s": time.perf_counter() - t0,
            "reduction": m.batch_reduction}


def slice_o_rank(rank: int, world: int, device: str, sizes: dict) -> dict:
    """Slice O on one rank: the four split paths, launches counted; then
    their times. `sizes`: the parent's O_SIZES."""
    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(dist.get_backend(), device)
    mesh = make_mesh(data=1, space=world)
    dmesh = make_mesh(data=world)
    out = {"rank": rank, "device": str(dev)}

    reset_counts()
    o1 = _o1_solve(dev, mesh)
    out["o1"] = {k: v for k, v in o1.items() if k not in ("A", "M", "b")}
    out["o1"]["x"] = o1["x"].cpu().numpy()
    n = O_NS_GRID
    fields = [local_block(f, mesh, 1, "space").contiguous()
              for f in _o_fields(n, dev)]
    o2 = {}
    for fused in (True, False):
        m = ldc_module(n, fused).to(dev)
        inputs = local_block(torch.from_numpy(m.dataset[0][0])[None].to(dev),
                             mesh, 1, "space").contiguous()
        with torch.no_grad():
            o2[fused] = _o_residual(m, fields, inputs, mesh)
    out["o2"] = {k: v.cpu().numpy() for k, v in o2.items()}
    m = ldc_module(n, True).to(dev)
    _sync()
    t0 = time.perf_counter()
    dx = _o3_gmres(m, fields, inputs, mesh)
    _sync()
    out["o3"] = {"dx": dx.cpu().numpy(),
                 "ms": (time.perf_counter() - t0) * 1e3}
    out["o4"] = _o4_fit(dev, dmesh)
    _sync()
    out["path_launches"] = counts()

    # times: each split call against its work without the exchange, every
    # rank at once on the shared card (host clock)
    A, b = o1["A"], o1["b"]
    ub = halo_exchange(b, mesh, 1, 0, zero_edges=False).contiguous()
    t0 = time.perf_counter()
    cg(A, b, tol=0.0, maxiter=O_ITERS, M=o1["M"], mesh=mesh)
    _sync()
    scalar = torch.zeros((), device=dev)
    stacked = torch.stack(fields)
    with torch.no_grad():
        out["times"] = {
            "o1_solve_ms_again": (time.perf_counter() - t0) * 1e3,
            "o1_matvec_split_ms": _host_ms(lambda: A(b)),
            "o1_matvec_kernel_on_block_ms": _host_ms(
                lambda: stencil_matvec(A.C, ub, kernel="cuda")),
            "allreduce_scalar_ms": _host_ms(
                lambda: mesh.all_reduce(scalar, "space")),
            "o2_split_ms": _host_ms(
                lambda: _o_residual(m, fields, inputs, mesh)),
            "o2_exchange_ms": _host_ms(lambda: halo_exchange(
                stacked, mesh, 1, -2, zero_edges=False)),
            "o2_allreduce_ms": _host_ms(lambda: all_reduce_sum(
                stacked[2].sum((-2, -1), keepdim=True), mesh)),
            # a step's gradient all-reduce (the three fields) and parts'
            "o4_allreduce_ms": _host_ms(lambda: dmesh.all_reduce(
                torch.zeros(3 * G3_GRID ** 2, device=dev), "data"))
            + _host_ms(lambda: dmesh.all_reduce(torch.zeros(3, device=dev),
                                                "data"))}
    if rank:
        g = out["o4"].pop("grad_first")
        out["o4"]["grad_first_sum"] = float(sum(
            np.abs(v).sum(dtype=np.float64) for v in g.values()))
    return out


def slice_o(dev, smi: str) -> dict:
    """Slice O: the one-process references on the card, then one group of
    O_WORLD ranks (slice_o_rank). Returns the ranks' launches on the
    paths, summed."""
    t0 = time.perf_counter()
    world = O_WORLD
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ref1 = _o1_solve(dev)
    t1 = time.perf_counter()
    cg(ref1["A"], ref1["b"], tol=0.0, maxiter=O_ITERS, M=ref1["M"])
    _sync()
    ref1["solve_ms_again"] = (time.perf_counter() - t1) * 1e3
    ref1 = {k: v for k, v in ref1.items() if k not in ("A", "M", "b")}
    ref1["x"] = ref1["x"].cpu().numpy()
    n = O_NS_GRID
    fields = _o_fields(n, dev)
    ref2 = {}
    for fused in (True, False):
        m = ldc_module(n, fused).to(dev)
        inputs = torch.from_numpy(m.dataset[0][0])[None].to(dev)
        with torch.no_grad():
            ref2[fused] = _o_residual(m, fields, inputs).cpu().numpy()
            if fused:
                ref2_ms = _host_ms(lambda: _o_residual(m, fields, inputs))
    m = ldc_module(n, True).to(dev)
    _sync()
    t3 = time.perf_counter()
    ref3 = _o3_gmres(m, fields, inputs).cpu().numpy()
    _sync()
    ref3_ms = (time.perf_counter() - t3) * 1e3
    ref4 = _o4_fit(dev)
    del m, fields, inputs
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_ranks(slice_o_rank, world,
                      (dev.type, {k: globals()[k] for k in O_SIZES}),
                      backend=backend, timeout=N_RANK_TIMEOUT, threads=2)
    ranks_s = time.perf_counter() - t_ranks
    r0 = ranks[0]
    times = r0["times"]
    head = {"nvidia_smi": smi, "backend": backend, "world": world}
    emit({"phase": "slice_O", **head, "ranks_s": ranks_s,
          "devices": [r["device"] for r in ranks],
          "path_launches_by_rank": [r["path_launches"] for r in ranks]})

    # O1: the split MG-CG against D3's variant in one process
    x = np.concatenate([r["o1"]["x"] for r in ranks], axis=0)
    err = float(np.abs(x - ref1["x"]).max())
    scale = float(np.abs(ref1["x"]).max())
    rel = [r["o1"]["relres"] for r in ranks]
    emit({"phase": "slice_O1", **head, "grid": [O_GRID, O_GRID],
          "iters": O_ITERS, "levels": r0["o1"]["levels"],
          "split_levels": r0["o1"]["split_levels"],
          "iterate_max_abs_err": err, "iterate_scale": scale,
          "atol": O1_ATOL, "relres": rel[0],
          "relres_plain_op": r0["o1"]["relres_plain_op"],
          "relres_one_process": ref1["relres"],
          "relres_plain_op_one_process": ref1["relres_plain_op"],
          "limit": RELRES_LIMIT,
          "setup_s_by_rank": [r["o1"]["setup_s"] for r in ranks],
          "setup_s_one_process": ref1["setup_s"],
          "solve_ms": r0["o1"]["solve_ms"],
          "solve_ms_again": times["o1_solve_ms_again"],
          "solve_ms_one_process": ref1["solve_ms"],
          "solve_ms_again_one_process": ref1["solve_ms_again"],
          "matvec_split_ms": times["o1_matvec_split_ms"],
          "matvec_kernel_on_block_ms": times["o1_matvec_kernel_on_block_ms"],
          "halo_share": 1.0 - times["o1_matvec_kernel_on_block_ms"]
          / times["o1_matvec_split_ms"],
          "allreduce_ms": times["allreduce_scalar_ms"],
          "k4_launches_by_rank": [r["path_launches"]["stencil_apply_2d"]
                                  for r in ranks]})
    if not err <= O1_ATOL * max(1.0, scale):
        fail(f"slice O1: the split MG-CG iterate is {err} off one "
             "process's")
    if len(set(rel)) != 1:
        fail(f"slice O1: the ranks' relres differ: {rel}")
    for key in ("relres", "relres_plain_op"):
        if not r0["o1"][key] <= RELRES_LIMIT:
            fail(f"slice O1: {key} {r0['o1'][key]} > {RELRES_LIMIT}")

    # O2: the split residual, with K6 and without, against one process
    errs = {}
    for fused in (True, False):
        got = np.concatenate([r["o2"][fused] for r in ranks], axis=-2)
        want = ref2[fused]
        route = "k6" if fused else "plain"
        errs[route] = e = {"max_abs_err": float(np.abs(got - want).max()),
                           "scale": float(np.abs(want).max())}
        if not e["max_abs_err"] <= FIELD_ATOL * max(1.0, e["scale"]):
            fail(f"slice O2: the split residual ({route}) is {e} off one "
                 "process's")
    split = times["o2_split_ms"]
    emit({"phase": "slice_O2", **head, "grid": [n, n],
          "block_rows": [r["o2"][True].shape[-2] for r in ranks],
          "errs": errs, "atol": FIELD_ATOL, "split_ms": split,
          "one_process_ms": ref2_ms,
          "exchange_ms": times["o2_exchange_ms"],
          "allreduce_ms": times["o2_allreduce_ms"],
          "halo_and_allreduce_share": (times["o2_exchange_ms"]
                                       + times["o2_allreduce_ms"]) / split})

    # O3: GMRES on the Jacobian action
    got = np.concatenate([r["o3"]["dx"] for r in ranks], axis=-2)
    e3 = float(np.abs(got - ref3).max())
    s3 = float(np.abs(ref3).max())
    emit({"phase": "slice_O3", **head, "grid": [n, n], **O_GMRES,
          "max_abs_err": e3, "scale": s3, "rtol": O3_RTOL,
          "ms_by_rank": [r["o3"]["ms"] for r in ranks],
          "one_process_ms": ref3_ms,
          # the split run's time beyond one process's: its exchanges and
          # all-reduces (a Jacobian action takes two exchanges and two
          # all-reduces, an Arnoldi step three more)
          "overhead_share": 1.0 - ref3_ms / r0["o3"]["ms"]})
    if not (np.isfinite(got).all() and e3 <= O3_RTOL * s3):
        fail(f"slice O3: the split GMRES direction is {e3} off one "
             f"process's (scale {s3})")

    # O4: the data-parallel Frobenius loss
    o4 = [r["o4"] for r in ranks]
    rel4 = max(abs(a - b) / abs(b) for a, b in zip(o4[0]["losses"],
                                                   ref4["losses"]))
    g_ref = ref4["grad_first"]
    g_scale = max(float(np.abs(g).max()) for g in g_ref.values())
    g_err = max(float(np.abs(o4[0]["grad_first"][k] - g).max())
                for k, g in g_ref.items())
    g_sums = [float(sum(np.abs(v).sum(dtype=np.float64)
                        for v in o4[0]["grad_first"].values()))] + [
        r["grad_first_sum"] for r in o4[1:]]
    emit({"phase": "slice_O4", **head, "grid": [G3_GRID, G3_GRID],
          "batch": G3_BATCH, "rows_a_rank": G3_BATCH // world,
          "reduction": o4[0]["reduction"], "losses": o4[0]["losses"],
          "losses_one_process": ref4["losses"], "max_rel_diff": rel4,
          "rtol": O4_LOSS_RTOL, "grad_first_max_abs_diff": g_err,
          "grad_first_scale": g_scale, "grad_rtol": O4_GRAD_RTOL,
          "fit_s_by_rank": [r["fit_s"] for r in o4],
          "fit_s_one_process": ref4["fit_s"],
          "allreduce_ms": times["o4_allreduce_ms"],
          "allreduce_share": times["o4_allreduce_ms"]
          / (o4[0]["fit_s"] * 1e3 / O4_STEPS),
          "k6_launches_by_rank": [r["path_launches"]["ns_vms_residual"]
                                  for r in ranks]})
    if o4[0]["reduction"] != "global" or len(o4[0]["losses"]) != O4_STEPS \
            or not all(math.isfinite(v) for v in o4[0]["losses"]):
        fail(f"slice O4: {o4[0]['reduction']} losses {o4[0]['losses']}")
    if any(r["losses"] != o4[0]["losses"] for r in o4) \
            or len(set(g_sums)) != 1:
        fail("slice O4: the ranks' losses or gradients differ")
    if not rel4 <= O4_LOSS_RTOL:
        fail(f"slice O4: losses {rel4} off the one-process run's")
    if not g_err <= O4_GRAD_RTOL * g_scale:
        fail(f"slice O4: the gradient of step 1 is {g_err} off one "
             f"process's (scale {g_scale})")
    for r in ranks:
        for name in ("stencil_apply_2d", "ns_vms_residual"):
            if r["path_launches"][name] <= 0:
                fail(f"slice O: rank {r['rank']} never launched {name}")
    emit({"phase": "slice_O_done", "seconds": time.perf_counter() - t0})
    return {k: sum(r["path_launches"][k] for r in ranks) for k in KERNELS}


# -- slice Q: the U-Nets and the IBN energy split over 'space' --------------
# Two paths over Q_WORLD ranks (as slices N and O: gloo with the ranks
# sharing the card where there are fewer cards than ranks, the halo rows
# and all-reduces through host memory; on one card NCCL is not measured),
# each held to one process on the same card, TF32 off, both networks from
# interop.seeded_params. Q1: IBNPoisson2D(source_from="inputs") with the
# JAX CLI's UNet(base_filters=16) (examples/poisson_ibn_parametric.py:54;
# three input channels) on a 256^2 image ensemble (SyntheticPointClouds'
# ellipses rasterised by the winding number, ImageIMBackObject's channels
# and unit forcing), data 1 x space 4, batch Q1_BATCH: every level on row
# blocks (the deepest 8 rows, 2 a rank). Q2: slice I's UNet3D(I_FILTERS)
# IBNPoisson3D at 32^3 laid out as the JAX dry run lays out four devices,
# data 2 x space 2, I_BATCH a data rank: the fifth Down's 2 planes
# gathered. Q_STEPS Adam steps each through Trainer.fit.
Q_WORLD = 4
Q_STEPS = 5
Q1_GRID, Q1_BATCH, Q1_FILTERS, Q1_LR, Q1_INIT_SEED = 256, 4, 16, 3e-4, 0
Q_LAYOUT = {"Q1": (1, 4), "Q2": (2, 2)}   # (data, space)
Q_LOSS_RTOL = 1e-4    # the losses against one process: the split sums
#                       (norms, energy) and the convolutions' blocks round
#                       otherwise, and Adam carries it on
# Parameters after the first Adam step (lr ~1e-3, each moves lr g/(|g|+eps),
# less than lr): within Q_PARAM_ATOL but for at most Q_PARAM_FRACTION of
# them. Where a gradient entry sits at rounding level (~1e-8, sums of O(1)
# terms that cancel) next to Adam's eps (1e-8), its rounding changes the
# step by up to ~lr, so no bound on the largest difference below 2 lr
# holds (slice I's UNet3D(16) data-parallel: on the CPU 4 of 4.2M entries
# moved more than 1e-6, on the card 5 and 6, at most 6.6e-4). A gradient
# wrong beyond rounding would move a whole tensor's entries.
Q_PARAM_ATOL = 1e-6
Q_PARAM_FRACTION = 1e-4
# Step 1's all-reduced gradient, entry by entry, within Q_GRAD_RTOL of its
# L2 norm of one process's on the global batch.
Q_GRAD_RTOL = 1e-5
Q_SIZES = ("Q_STEPS", "Q1_GRID", "Q1_BATCH", "Q1_FILTERS", "I_FILTERS",
           "I_BATCH", "I_GRID")


class _Arrays:
    """``(inputs[i], forcing[i])`` items of two arrays."""

    def __init__(self, inputs, forcing):
        self.inputs, self.forcing = inputs, forcing

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, i):
        return self.inputs[i], self.forcing[i]


def _q_data() -> dict:
    """Each path's Q_STEPS global batches, ``(inputs, forcing)`` float32:
    Q1's image ensemble and Q2's topologies (slice I's)."""
    n = Q1_GRID
    clouds = SyntheticPointClouds(n_samples=Q_STEPS * Q1_BATCH,
                                  domain_size=n)
    c = torch.from_numpy(np.stack([clouds[i][0]
                                   for i in range(len(clouds))]))
    chi = occupancy_from_cloud(c[..., 0:2], c[..., 2:4], c[..., 4],
                               (n, n)).numpy()
    walls = np.broadcast_to(clouds.bc2, chi.shape)
    q1 = (np.stack([1.0 - chi, chi, walls], -1).astype(np.float32),
          np.ones(chi.shape + (1,), np.float32))
    bs = Q_LAYOUT["Q2"][0] * I_BATCH
    topo = TopoDataset3D([synthesize_topology_3d(n=I_GRID, seed=s)
                          for s in range(Q_STEPS * bs)], domain_size=I_GRID)
    items = [topo[i] for i in range(len(topo))]
    q2 = (np.stack([a for a, _ in items]), np.stack([f for _, f in items]))
    return {"Q1": q1, "Q2": q2}


def _q_module(q: str, mesh=None):
    """Q1's or Q2's IBN module, its network from seeded_params, built on
    `mesh` (None: one process); and its global batch and learning rate."""
    if q == "Q1":
        net = UNet(3, 1, base_filters=Q1_FILTERS, mesh=mesh)
        seed, bs, lr = Q1_INIT_SEED, Q1_BATCH, Q1_LR
    else:
        net = UNet3D(3, 1, base_filters=I_FILTERS, mesh=mesh)
        seed, bs, lr = I_INIT_SEED, Q_LAYOUT["Q2"][0] * I_BATCH, I_LR
    net.load_state_dict(params_from_jax(seeded_params(flax_shapes(net),
                                                      seed)))
    if q == "Q1":
        m = IBNPoisson2D(net, source_from="inputs", domain_size=Q1_GRID,
                         batch_size=bs, learning_rate=lr, mesh=mesh)
    else:
        m = IBNPoisson3D(net, domain_size=I_GRID, batch_size=bs,
                         learning_rate=lr, mesh=mesh)
    return m, bs, lr


def _q_fit(q: str, data, dev, mesh=None, record: bool = True) -> dict:
    """Q_STEPS Adam steps of `q` through Trainer.fit over its shuffled
    batches: one process on the global batch, or this rank's block over
    `mesh` (its rows along 'data', its axis 1 along 'space'). Its losses,
    seconds, ms a step (the median of steps 2 on, each timed from the end
    of the one before: the loader's batch, the step, its all-reduces and
    Adam) and the peak memory the fit allocated above what was allocated
    as it began; with `record`, step 1's gradients (the all-reduced ones
    over a mesh) and the parameters after it."""
    m, bs, lr = _q_module(q, mesh)
    loader = NumpyLoader(_Arrays(*data), batch_size=bs, shuffle=True,
                         device=dev, mesh=mesh,
                         space_axis=None if mesh is None else 1)
    tr = Trainer(max_epochs=1, optimizer="adam", learning_rate=lr,
                 device=dev)
    after, ends = {}, []

    def post(opt, args, kwargs):
        if record and not after:
            after.update({k: v.detach().cpu().numpy().copy()
                          for k, v in m.network.state_dict().items()})
        _sync()
        ends.append(time.perf_counter())

    start = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
    handle = register_optimizer_step_post_hook(post)
    t0 = time.perf_counter()
    try:
        if record:
            grads = first_step_grads(m, lambda: tr.fit(m, loader))
        else:
            tr.fit(m, loader)
            grads = {}
        _sync()
    finally:
        handle.remove()
    dt = time.perf_counter() - t0
    return {"losses": tr.step_losses, "after_first": after,
            "grad_first": grads, "fit_s": dt,
            "step_ms": float(statistics.median(np.diff(ends))) * 1e3,
            "peak_memory_bytes": (
                torch.cuda.max_memory_allocated(dev) - start
                if dev.type == "cuda" else None)}


@contextlib.contextmanager
def _exchange_clock():
    """Seconds spent in the split net's collectives while it is open: the
    halo exchanges (``mesh._swap``, forward and backward), the gathers of
    the deep levels (``mesh._gather``) and the differentiable all-reduces
    (``_AllReduceSum``: the norms' two sums and the energy's), and apart
    from them the Trainer's all-reduce of the gradients
    (``Trainer._all_reduce``), each timed from a synchronised card, so
    that the work queued before it is not counted in it."""
    spent = {"halo": 0.0, "gather": 0.0, "allreduce": 0.0, "grads": 0.0}
    swap, gather = mesh_mod._swap, mesh_mod._gather
    grads = Trainer._all_reduce
    fwd, bwd = mesh_mod._AllReduceSum.forward, mesh_mod._AllReduceSum.backward

    def clocked(fn, key):
        def run(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    mesh_mod._swap = clocked(swap, "halo")
    mesh_mod._gather = clocked(gather, "gather")
    mesh_mod._AllReduceSum.forward = staticmethod(clocked(fwd, "allreduce"))
    mesh_mod._AllReduceSum.backward = staticmethod(clocked(bwd, "allreduce"))
    Trainer._all_reduce = clocked(grads, "grads")
    try:
        yield spent
    finally:
        mesh_mod._swap, mesh_mod._gather = swap, gather
        Trainer._all_reduce = grads
        mesh_mod._AllReduceSum.forward = staticmethod(fwd)
        mesh_mod._AllReduceSum.backward = staticmethod(bwd)


def slice_q_rank(rank: int, world: int, device: str, sizes: dict,
                 data: dict) -> dict:
    """Slice Q on one rank: Q1 on a 1 x 4 mesh and Q2 on a 2 x 2 mesh of
    the group, launches counted; then a fit of each with its collectives
    clocked. `sizes`: the parent's Q_SIZES."""
    globals().update(sizes)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = rank_device(dist.get_backend(), device)
    meshes = {q: make_mesh(data=d, space=k) for q, (d, k) in Q_LAYOUT.items()}
    out = {"rank": rank, "device": str(dev)}
    reset_counts()
    for q in Q_LAYOUT:
        out[q] = _q_fit(q, data[q], dev, meshes[q])
    _sync()
    out["path_launches"] = counts()
    for q in Q_LAYOUT:
        with _exchange_clock() as spent:
            clocked = _q_fit(q, data[q], dev, meshes[q], False)
        out[q].update(
            clocked_step_ms=clocked["fit_s"] * 1e3 / Q_STEPS,
            **{f"{k}_ms_a_step": v * 1e3 / Q_STEPS
               for k, v in spent.items()})
        if rank:
            for key in ("after_first", "grad_first"):
                got = out[q].pop(key)
                out[q][key + "_sum"] = float(sum(
                    np.abs(v).sum(dtype=np.float64) for v in got.values()))
    return out


def _q_check(q: str, ref: dict, ranks: list, head: dict, smi: str) -> None:
    """Q1's or Q2's line and checks: the split fit against one process's."""
    got = [r[q] for r in ranks]
    g0 = got[0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(g0["losses"],
                                                  ref["losses"]))
    diffs = [np.abs(g0["after_first"][k] - v)
             for k, v in ref["after_first"].items()]
    dp = max(float(d.max()) for d in diffs)
    off = sum(int((d > Q_PARAM_ATOL).sum()) for d in diffs) / sum(
        d.size for d in diffs)
    g_ref = ref["grad_first"]
    g_norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                           for g in g_ref.values()))
    g_err = max(float(np.abs(g0["grad_first"][k] - g).max())
                for k, g in g_ref.items())
    sums = {key: [float(sum(np.abs(v).sum(dtype=np.float64)
                            for v in g0[key].values()))]
            + [r[key + "_sum"] for r in got[1:]]
            for key in ("after_first", "grad_first")}
    split_ms = g0["step_ms"]
    comm_ms = sum(g0[f"{k}_ms_a_step"] for k in ("halo", "gather",
                                                   "allreduce"))
    data, space = Q_LAYOUT[q]
    emit({"phase": f"slice_{q}", "nvidia_smi": smi, **head,
          "mesh": {"data": data, "space": space},
          "grid": [Q1_GRID] * 2 if q == "Q1" else [I_GRID] * 3,
          "base_filters": Q1_FILTERS if q == "Q1" else I_FILTERS,
          "batch": Q1_BATCH if q == "Q1" else data * I_BATCH,
          "steps": Q_STEPS, "losses": g0["losses"],
          "losses_one_process": ref["losses"], "max_rel_diff": rel,
          "rtol": Q_LOSS_RTOL, "params_after_first_max_abs_diff": dp,
          "params_after_first_share_off": off,
          "params_atol": Q_PARAM_ATOL, "params_fraction": Q_PARAM_FRACTION,
          "grad_first_max_abs_diff": g_err, "grad_first_norm": g_norm,
          "grad_first_rel_to_norm": g_err / g_norm,
          "grad_rtol": Q_GRAD_RTOL,
          # ms a step from step 2 on (the loader and Adam included),
          # split (every rank at once on the shared card) and in one
          # process
          "step_ms_split": split_ms,
          "step_ms_split_by_rank": [r["step_ms"] for r in got],
          "step_ms_one_process": ref["step_ms"],
          # a fit with its collectives clocked (each from a synchronised
          # card): ms a step in the halo exchanges, the deep levels'
          # gathers and the norms' and energy's all-reduces, and their
          # share of that fit's step; beside them the gradients'
          # all-reduce
          "clocked_step_ms": g0["clocked_step_ms"],
          **{f"{k}_ms_a_step": g0[f"{k}_ms_a_step"]
             for k in ("halo", "gather", "allreduce", "grads")},
          "exchange_share": comm_ms / g0["clocked_step_ms"],
          "grads_share": g0["grads_ms_a_step"] / g0["clocked_step_ms"],
          # the peak a fit allocated above what was allocated as it began
          "peak_memory_bytes_by_rank": [r["peak_memory_bytes"] for r in got],
          "peak_memory_bytes_one_process": ref["peak_memory_bytes"],
          "nccl": "not measured: one card, its ranks over gloo"
          if head["backend"] == "gloo" else "measured"})
    if len(g0["losses"]) != Q_STEPS or \
            not all(math.isfinite(v) for v in g0["losses"]):
        fail(f"slice {q}: losses {g0['losses']}")
    if any(r["losses"] != g0["losses"] for r in got):
        fail(f"slice {q}: the ranks logged different losses")
    for key, v in sums.items():
        if len(set(v)) != 1:
            fail(f"slice {q}: the ranks' {key} differ: {v}")
    if not rel <= Q_LOSS_RTOL:
        fail(f"slice {q}: losses {rel} off the one-process run's")
    if not g_err <= Q_GRAD_RTOL * g_norm:
        fail(f"slice {q}: the all-reduced gradient of step 1 is {g_err} "
             f"off one process's (norm {g_norm})")
    if not off <= Q_PARAM_FRACTION:
        fail(f"slice {q}: a share {off} of the parameters after step 1 "
             f"more than {Q_PARAM_ATOL} off one process's (at most {dp})")


def slice_q(dev, smi: str) -> dict:
    """Slice Q: the data, the one-process references on the card, then one
    group of Q_WORLD ranks (slice_q_rank). Returns the ranks' launches on
    the path, summed (no kernel of the table lies on it: the convolutions
    are cuDNN's, the energy plain)."""
    t0 = time.perf_counter()
    world = Q_WORLD
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    data = _q_data()
    refs = {}
    for q in Q_LAYOUT:
        refs[q] = _q_fit(q, data[q], dev)
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_ranks(slice_q_rank, world,
                      (dev.type, {k: globals()[k] for k in Q_SIZES}, data),
                      backend=backend, timeout=N_RANK_TIMEOUT, threads=2)
    head = {"backend": backend, "world": world,
            "device_count": torch.cuda.device_count(),
            "ranks_s": time.perf_counter() - t_ranks}
    for q in Q_LAYOUT:
        _q_check(q, refs[q], ranks, head, smi)
    emit({"phase": "slice_Q_done", "seconds": time.perf_counter() - t0})
    return {k: sum(r["path_launches"][k] for r in ranks) for k in KERNELS}


# Slice P, the entry points: the port's example CLIs
# (diffnet_tpu_torch.examples) called in-process through main(argv) on the
# card, so that the launch counters count them. P1-P5 at their documented
# configurations with --fused-kernels; P6 every other CLI and physics once,
# at tests/test_examples_smoke.py's argv (ns_fps and eikonal_parametric at
# examples/run_all.sh's).
P1_LIMIT = L2_LIMIT      # slice A's; JAX's CLI prints 2.046e-4
JAX_P2_REL_L2 = 4.122e-4   # scripts/torch_port_reference_cli.py P2, on a CPU
P2_LIMIT = 1.3 * JAX_P2_REL_L2
# The JAX CLI runs the unfused residual, whose float32 rounding sets its
# figure at 513^2; with the stiffness kernel's form (P2-K1 of the same
# script: the JAX CLI with fused_kernels=True, Pallas interpreted) it
# reaches the discretisation error, as the port's --fused-kernels run does
JAX_P2_K1_REL_L2 = 3.195e-6
P2_K1_LIMIT = 1.3 * JAX_P2_K1_REL_L2
P3_LIMIT = E1_LIMIT      # 1.3x JAX's 2.752e-2
# scripts/ldc_validation.py's 129^2 Re-1000 figures (docs/SOLVERS.md:81-88):
# Ghia midline max errors and the Newton iterations of each level
JAX_P4 = {"ghia_err_u": 0.0356, "ghia_err_v": 0.0375,
          "newton_iters": {33: 12, 65: 7, 129: 7}}
P4_GHIA_FACTOR = 1.1
P4_ITERS_SLACK = 3       # each level at most JAX's + 3 (the cap is 30)
P4_F_LIMIT = 1e-6        # |F| at the end of every level
P6 = (   # (module, argv, run directory, artifacts)
    ("poisson_3d", ["--domain-size", 9, "--max-epochs", 3], "poisson-3d",
     ("u3d.vti",)),
    ("stokes_mms", ["--domain-size", 12, "--max-epochs", 3], "stokes-mms",
     ("uvp.png", "best.ckpt")),
    ("stokes_mms", ["--domain-size", 17, "--solver", "gmres"], "stokes-mms",
     ("uvp.png",)),
    ("ns_ldc", ["--domain-size", 12, "--max-epochs", 3], "ns-ldc-re100",
     ("midline_cuts.csv", "fields.png")),
    ("ns_ldc", ["--domain-size", 17, "--solver", "newton"], "ns-ldc-re100",
     ("midline_cuts.csv",)),
    ("eikonal_reconstruction", ["--domain-size", 16, "--max-epochs", 2],
     "eikonal2d", ("sdf.png",)),
    ("eikonal_reconstruction", ["--nsd", 3, "--domain-size", 9,
                                "--max-epochs", 2], "eikonal3d",
     ("surface.obj",)),
    ("poisson_ibn_parametric", ["-b", 4, "--n-samples", 8, "--max-epochs",
                                1, "--domain-size", 16], "ibn-2d",
     ("sample.png", "best.ckpt")),
    ("ibn_3d", ["--domain-size", 16, "--batch-size", 2, "--n-samples", 4,
                "--max-epochs", 1], "ibn-3d", ("u.vti", "object.obj")),
    ("ns_fpc_parametric", ["--max-epochs", 1, "--n-samples", 2,
                           "--batch-size", 2, "--width", 64, "--height", 32,
                           "--base-filters", 2], "ns-fpc-synthetic",
     ("fields.png",)),
    ("eikonal_airfoil", ["--domain-size", 16, "--max-epochs", 2],
     "eikonal-airfoil-teardrop", ("sdf.png",)),
    *(("more_physics", [ph, "--domain-size", 16, "--max-epochs", 2], ph, ())
      for ph in ("helmholtz", "advdiff", "allen-cahn", "burgers", "fsdt",
                 "topopt")),
    ("sweep", ["--physics", "klsum", "--param", "n_train", "--values",
               "4,8", "--domain-size", 16, "--max-epochs", 1,
               "--batch-size", 4], "sweep-klsum-n_train",
     ("sweep.csv", "stats.json", "sweep.png")),
    ("ns_fps", ["--eq", "stokes", "--re", 1, "--h", 0.5], "fps-stokes-re1",
     ("solution.npz", "contours.png")),
    ("eikonal_parametric", ["--net", "immdiff", "--n-train", 3, "--n-test",
                            1, "--domain-size", 32, "--n-points", 48,
                            "--max-epochs", 20], "eik-param-immdiff",
     ("heldout.png", "errors.txt")),
)


P_EXTRA_ARGV: list = []   # a CPU rehearsal sets ["--device", "cpu"]


def _p_cli(name: str, argv: list) -> tuple[dict, dict]:
    """``diffnet_tpu_torch.examples.<name>.main(argv)`` on the card, its
    printed lines kept: (its return, {last_line, seconds, launches})."""
    mod = importlib.import_module(f"diffnet_tpu_torch.examples.{name}")
    buf = io.StringIO()
    before = counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main([str(a) for a in argv] + P_EXTRA_ARGV)
    torch.cuda.synchronize()
    lines = buf.getvalue().strip().splitlines()
    return out, {"argv": [str(a) for a in argv],
                 "last_line": lines[-1] if lines else "",
                 "seconds": time.perf_counter() - t0,
                 "launches": since(before)}


@contextlib.contextmanager
def _last_graph():
    """Yields a list that holds, after the block, the last
    ``krylov.CudaGraphed`` made in it (kept alive, with the operator and
    the buffers it captured, so that it can be replayed after the entry
    point has returned). Every CUDA graph captured in the block keeps its
    node list (``keep_graph=True``, instantiated at its first replay;
    ``enable_debug_mode``), for ``debug_dump``."""
    made = []
    init = krylov.CudaGraphed.__init__
    graph_cls = torch.cuda.CUDAGraph

    def record(self, fn):
        init(self, fn)
        made[:] = [self]

    class Kept(graph_cls):
        def __init__(self, keep_graph=True):
            super().__init__(True)
            self.enable_debug_mode()

    krylov.CudaGraphed.__init__ = record
    torch.cuda.CUDAGraph = Kept
    try:
        yield made
    finally:
        krylov.CudaGraphed.__init__ = init
        torch.cuda.CUDAGraph = graph_cls


def _graph_kernel_nodes(graph) -> tuple[dict, int]:
    """The kernel nodes of a captured graph, from its DOT dump: the count
    of each kernel of the table, and of all kernel nodes."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            # one record a node, ended by '"];'; a kernel's starts {KERNEL
            # and names its (mangled) function on the next line
            nodes = [b for b in f.read().split('"];') if "{KERNEL" in b]
    return ({k: sum(KERNEL_SYMBOLS[k] in b for b in nodes)
             for k in KERNELS}, len(nodes))


def _replay_check(what: str, made: list, kernel: str) -> dict:
    """What one replay of the graph in `made` launches. A replay runs each
    node of the graph once, so each kernel's count among the graph's
    nodes must equal what the replay adds to its launch count
    (``CudaGraphed`` adds, at each replay, the launches its capture
    made), and `kernel` must be among them. The replay runs under
    torch.profiler too: each kernel's count in the trace is reported and
    may not exceed the launch count. It can fall short: late in a full
    run the trace loses device events (three runs showed 5, 6 and 6 of
    the V-cycle's 7 K1 nodes, and 0 of a GMRES step's one K6 node, with
    1,012-1,020 events of the 1,057 that a fresh process traces, the
    graph's 1,055 kernels and two copies). The counts are restored
    after: the check is no part of the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not made or made[0].graph is None:
        fail(f"{what}: the entry point made no CUDA graph")
    g = made.pop()
    nodes, kernel_nodes = _graph_kernel_nodes(g.graph)
    x = g.x.clone()
    torch.cuda.synchronize()
    before = counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g(x)
        torch.cuda.synchronize()
    counted = since(before)
    for name, (mod, attr, _, _) in KERNELS.items():
        setattr(mod, attr, before[name])
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    traced = {k: sum(KERNEL_SYMBOLS[k] in n for n in names)
              for k in KERNELS}
    row = {"counted": counted, "graph_nodes": nodes,
           "graph_kernel_nodes": kernel_nodes, "traced": traced,
           "device_events": len(names)}
    if (nodes != counted or counted[kernel] <= 0
            or any(traced[k] > counted[k] for k in KERNELS)):
        fail(f"{what}: one replay: {row}")
    return row


def slice_p(dev, smi: str) -> dict:
    """The entry points (see P1-P6 above): each entry one JSON line with
    its figures, seconds and launches; returns each entry's launches."""
    out = {}
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        # P1: the README quick start through the CLI (slice A's problem)
        r, line = _p_cli("poisson_mms_2d", [
            "--domain-size", 64, "--loss-type", "resmin", "--optimizer",
            "lbfgs", "--max-epochs", 80, "--fused-kernels", "--out-dir",
            tmp])
        line.update(phase="slice_P1", nvidia_smi=smi, rel_l2=r["rel_l2"],
                    optimizer="zoom",
                    limit=P1_LIMIT, jax_reference=2.046e-4,
                    lbfgs_max_iter="the Trainer's default, 5 (slice A: 10)")
        emit(line)
        if not (r["u"].shape == (64, 64) and np.isfinite(r["u"]).all()
                and r["rel_l2"] <= P1_LIMIT):
            fail(f"slice P1: rel L2 {r['rel_l2']} > {P1_LIMIT}")
        for f in ("metrics.csv", "best.ckpt", "u.vti", "contours.png"):
            if not os.path.exists(os.path.join(r["run_dir"], f)):
                fail(f"slice P1: no {f}")
        out["P1"] = line["launches"]

        # P2: the 513^2 MG-CG solve, K1 on the fine level and the outer CG
        with _last_graph() as made:
            r, line = _p_cli("poisson_mms_2d", [
                "--domain-size", 513, "--optimizer", "mg-cg",
                "--fused-kernels", "--out-dir", tmp])
        line.update(phase="slice_P2", nvidia_smi=smi, rel_l2=r["rel_l2"],
                    solve_s=r["solve_s"], limit=P2_LIMIT,
                    jax_reference=JAX_P2_REL_L2, limit_k1=P2_K1_LIMIT,
                    jax_reference_k1=JAX_P2_K1_REL_L2,
                    vcycle_replay=_replay_check("slice P2's V-cycle", made,
                                                "poisson_stiffness_action"))
        emit(line)
        if not (np.isfinite(r["u"]).all() and r["rel_l2"] <= P2_LIMIT
                and r["rel_l2"] <= P2_K1_LIMIT):
            fail(f"slice P2: rel L2 {r['rel_l2']} > {P2_K1_LIMIT}")
        out["P2"] = line["launches"]

        # P3: examples/poisson_3d.py at its default 17^3 through K5
        r, line = _p_cli("poisson_3d", ["--domain-size", 17, "--max-epochs",
                                        60, "--fused-kernels", "--out-dir",
                                        tmp])
        line.update(phase="slice_P3", nvidia_smi=smi, rel_l2=r["rel_l2"],
                    optimizer="zoom",
                    limit=P3_LIMIT, jax_reference=JAX_E1_REL_L2)
        emit(line)
        if not (np.isfinite(r["u"]).all() and r["rel_l2"] <= P3_LIMIT):
            fail(f"slice P3: rel L2 {r['rel_l2']} > {P3_LIMIT}")
        out["P3"] = line["launches"]

        # P4: the Ghia Re-1000 check, 33 -> 65 -> 129 through K6
        png = os.path.join(tmp, "ghia.png")
        with _last_graph() as made:
            r, line = _p_cli("ldc_validation", [
                "--re", 1000, "--solver", "newton", "--domain-size", 129,
                "--fused-kernels", "--out", png])
        # the last Newton direction's preconditioned Jacobian action
        line["gmres_step_replay"] = _replay_check(
            "slice P4's GMRES step", made, "ns_vms_residual")
        levels = [{k: lv[k] for k in ("n", "newton_iters", "final_F",
                                      "seconds")}
                  | {"jax_newton_iters": JAX_P4["newton_iters"][lv["n"]]}
                  for lv in r["levels"]]
        line.update(phase="slice_P4", nvidia_smi=smi, levels=levels,
                    ghia_err_u=r["ghia_err_u"], ghia_err_v=r["ghia_err_v"],
                    jax_reference=JAX_P4, ghia_factor=P4_GHIA_FACTOR,
                    iters_slack=P4_ITERS_SLACK, F_limit=P4_F_LIMIT)
        emit(line)
        if [lv["n"] for lv in levels] != [33, 65, 129]:
            fail(f"slice P4: levels {levels}")
        for lv in levels:
            if not lv["final_F"] < P4_F_LIMIT:
                fail(f"slice P4: |F| {lv['final_F']} at n={lv['n']}")
            if lv["newton_iters"] > lv["jax_newton_iters"] + P4_ITERS_SLACK:
                fail(f"slice P4: {lv['newton_iters']} Newton iterations at "
                     f"n={lv['n']}, JAX {lv['jax_newton_iters']}")
        for key in ("ghia_err_u", "ghia_err_v"):
            if not r[key] <= P4_GHIA_FACTOR * JAX_P4[key]:
                fail(f"slice P4: {key} {r[key]} > {P4_GHIA_FACTOR} x "
                     f"{JAX_P4[key]}")
        if not (os.path.exists(png) and np.isfinite(r["u"]).all()):
            fail("slice P4: no plot, or the field is not finite")
        out["P4"] = line["launches"]

        # P5: KL-sum UQ training, then the query of its run directory
        r, line = _p_cli("klsum_uq", ["--domain-size", 64, "--max-epochs",
                                      3, "--fused-kernels", "--out-dir",
                                      tmp])
        q, qline = _p_cli("query_run", [r["run_dir"], "--domain-size", 64,
                                        "--fused-kernels"])
        saved = torch.load(os.path.join(r["run_dir"], "best.ckpt"),
                           map_location="cpu", weights_only=True)
        with open(os.path.join(r["run_dir"], "metrics.csv")) as f:
            losses = [float(row["loss"]) for row in csv.DictReader(f)]
        reload_equal = all(torch.equal(q["params"][k], v)
                           for k, v in saved.items())
        # the last epoch was the best: best.ckpt holds the trained network
        trained_equal = (losses[-1] > min(losses)) or all(
            torch.equal(saved[k], v) for k, v in r["params"].items())
        launches = {k: line["launches"][k] + qline["launches"][k]
                    for k in line["launches"]}
        line = {"phase": "slice_P5", "nvidia_smi": smi, "klsum": line,
                "query_run": qline, "epoch_losses": losses,
                "q_mean_range": [float(q["mean"].min()),
                                 float(q["mean"].max())],
                "reloaded_equal_saved": reload_equal,
                "saved_equal_trained": trained_equal,
                "launches": launches}
        emit(line)
        for f in ("best.ckpt", "q_mean.npy", "q_mean.vti"):
            if not os.path.exists(os.path.join(r["run_dir"], f)):
                fail(f"slice P5: no {f}")
        if not (np.isfinite(q["mean"]).all() and reload_equal
                and trained_equal):
            fail(f"slice P5: q_mean finite {np.isfinite(q['mean']).all()}, "
                 f"reload {reload_equal}, trained {trained_equal}")
        out["P5"] = launches

        # P6: every other CLI and physics once
        rows = []
        for name, argv, run, files in P6:
            argv = list(argv) + ["--out-dir", tmp]
            r, line = _p_cli(name, argv)
            missing = [f for f in files
                       if not os.path.exists(os.path.join(r["run_dir"], f))]
            rows.append({"cli": name, **line, "missing": missing})
            if missing or not r["run_dir"].startswith(os.path.join(tmp, run)):
                fail(f"slice P6: {name} {argv}: missing {missing}")
        emit({"phase": "slice_P6", "nvidia_smi": smi, "runs": rows,
              "optimizer": "zoom",
              "seconds": sum(row["seconds"] for row in rows)})
        out["P6"] = {k: sum(row["launches"][k] for row in rows)
                     for k in KERNELS}
    return out


# -- slice R: the study scripts as entry points ---------------------------
# Each case as scripts/torch_port_reference_studies.py runs it from
# scripts/torch_port_reference_studies_cases.py; JAX_R holds the figures
# that script prints (JAX_PLATFORMS=cpu python
# scripts/torch_port_reference_studies.py).
from torch_port_reference_studies_cases import (  # noqa: E402
    R1_ROWS, R2_ACC_GRIDS, R2_TP_BATCH, R2_TP_GRID, R3_CASE, R3_H,
    R3_NEWTON_CAP, midline_cuts)
R1_ERR_FACTOR = 1.3     # each error at most 1.3x JAX's at the same grid
R1_RATE_SLACK = 0.25    # each rate at least JAX's less 0.25
R2_F32_FACTOR = 1.3     # section 2's f32 solve at most 1.3x JAX's
R2_ACC_FACTOR = 1.3     # section 1's library route at most 1.3x JAX's
R2_MOVED = 0.95         # a section 2 bf16 row below it where JAX's is:
                        # its field left the zero start (rel L2 1)
R2_BF16_FACTOR = 1.3    # and at most 1.3x JAX's, as the f32 row is held
R3_CUT_ATOL = 1e-4      # the midline cuts, times max |u| of JAX's solution
R3_ITERS_SLACK = 2      # Newton iterations: JAX's + 2 (JAX below its cap)
JAX_R = {   # scripts/torch_port_reference_studies.py, on a CPU
    "r1_errs": {
        "poisson-resmin-deg1": [0.0032090572640299797, 0.0008017112268134952],
        "poisson-resmin-deg2": [0.0032191467471420765, 0.0004097116179764271],
        "poisson-resmin-deg3": [0.0037288705352693796, 0.00024552023387514055],
    },
    "r1_rates": {
        "poisson-resmin-deg1": [2.0009949516656285],
        "poisson-resmin-deg2": [2.973997636361858],
        "poisson-resmin-deg3": [3.924824877951393],
    },
    "r2_accuracy": {
        "128": 0.005811598798782653,
        "512": 0.004236866356330107,
    },
    "r2_solve": {
        "f32": 0.0002045467699645087,
        "bf16-residual": 0.6374367475509644,
        "bf16-accum": 0.6815817356109619,
    },
    "r2_adam": {
        "float32": 0.002110250759869814,
        "bfloat16": 0.035361483693122864,
    },
    "r3_newton_iters": 5,
    "r3_final_F": 9.661664535087766e-07,
    "r3_u_max": 1.224822998046875,
    "r3_grid": [49, 25],
    "r3_cuts": {
        "uX": [
            1.0, 0.9900338053703308, 0.9569130539894104, 0.8984875082969666,
            0.8064752817153931, 0.6668428182601929, 0.45015233755111694,
            0.19014954566955566, 0.0, 0.0, 0.0, 0.0, 0.0,
            -0.0030498052947223186, 0.001579680247232318,
            0.046037688851356506, 0.10479899495840073, 0.1693103313446045,
            0.23462055623531342, 0.2983630299568176, 0.3592732846736908,
            0.41667747497558594, 0.4702262580394745, 0.5197715759277344,
            0.5653008818626404, 0.6068977117538452, 0.6447154879570007,
            0.6789564490318298, 0.7098554372787476, 0.7376658320426941,
            0.7626480460166931, 0.7850608825683594, 0.8051545023918152,
            0.8231661319732666, 0.8393160700798035, 0.8538072109222412,
            0.866823136806488, 0.8785296082496643, 0.8890742063522339,
            0.8985881805419922, 0.9071876406669617, 0.9149746298789978,
            0.9220386743545532, 0.9284574389457703, 0.9342979192733765,
            0.939616322517395, 0.944457471370697, 0.9488582611083984,
            0.9526558518409729],
        "pX": [
            1.0108532905578613, 1.0030218362808228, 1.0237226486206055,
            1.0673656463623047, 1.1372275352478027, 1.2394599914550781,
            1.3373663425445557, 1.4364768266677856, 1.3681694269180298,
            0.7626838684082031, 0.36120957136154175, 0.14059747755527496,
            0.03319673240184784, -0.00822337158024311, 0.046373043209314346,
            0.08493789285421371, 0.12521623075008392, 0.1577530801296234,
            0.1826629787683487, 0.20011459290981293, 0.21102678775787354,
            0.2164195477962494, 0.21731704473495483, 0.21466585993766785,
            0.2093050628900528, 0.2019527703523636, 0.1932050883769989,
            0.1835421472787857, 0.1733391433954239, 0.1628798246383667,
            0.15237131714820862, 0.14195843040943146, 0.13173699378967285,
            0.12176544964313507, 0.11207467317581177, 0.10267584770917892,
            0.09356683492660522, 0.0847366601228714, 0.0761692076921463,
            0.06784561276435852, 0.05974608659744263, 0.051851071417331696,
            0.044142190366983414, 0.03660300001502037, 0.029219746589660645,
            0.021982461214065552, 0.014885183423757553, 0.007984739728271961,
            0.0],
        "uY": [
            0.0, 0.364624947309494, 0.6390312314033508, 0.8488430976867676,
            1.0156445503234863, 1.146264672279358, 1.2222578525543213,
            1.1918056011199951, 0.9711106419563293, 0.5302475094795227, 0.0,
            0.0, 0.0, 0.0, 0.0, 0.5302474498748779, 0.9711105823516846,
            1.1918054819107056, 1.2222578525543213, 1.146264672279358,
            1.0156444311141968, 0.8488430380821228, 0.6390312910079956,
            0.3646250069141388, 0.0],
        "vY": [
            0.0, -0.009507632814347744, -0.039170585572719574,
            -0.0817614272236824, -0.13124004006385803, -0.17895138263702393,
            -0.21006068587303162, -0.20199653506278992, -0.13474227488040924,
            -0.051867563277482986, 0.0, 0.0, 0.0, 0.0, 0.0,
            0.051867567002773285, 0.13474228978157043, 0.20199652016162872,
            0.21006068587303162, 0.17895138263702393, 0.13124004006385803,
            0.08176141232252121, 0.03917057439684868, 0.009507648646831512,
            0.0],
    },
}


def _counting(mod, name: str, log: list):
    """Wrap ``mod.name`` so that each call appends its kernel launches and
    seconds to `log`; returns the restore."""
    fn = getattr(mod, name)

    def counted(*args, **kw):
        before = counts()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append({"n": args[0], "seconds": time.perf_counter() - t0,
                    "launches": since(before)})
        return out

    setattr(mod, name, counted)
    return lambda: setattr(mod, name, fn)


def slice_r1(dev, smi: str, tmp: str) -> dict:
    """The convergence study's --quick Poisson resmin rows: deg 1 through
    K1 (--fused-kernels), deg 2 and 3 plain (they refuse the flag)."""
    from diffnet_tpu_torch.examples import convergence_study as cs

    fused = [k for k, (_, _, k1) in R1_ROWS.items() if k1]
    plain = [k for k, (_, _, k1) in R1_ROWS.items() if not k1]
    refused = False
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            cs.main(["--quick", "--rows", *plain, "--fused-kernels",
                     "--out", os.path.join(tmp, "refused.md")])
    except SystemExit:
        refused = True
    if not refused:
        fail("slice R1: the deg-2/3 rows took --fused-kernels")
    solves, launches = [], {name: 0 for name in KERNELS}
    restore = _counting(cs, "solve_poisson", solves)
    try:
        rows = []
        for keys, flag in ((fused, ["--fused-kernels"]), (plain, [])):
            r, line = _p_cli("convergence_study", [
                "--quick", "--rows", *keys, *flag, "--out",
                os.path.join(tmp, "CONVERGENCE.md")])
            rows += r["rows"]
            launches = {k: v + line["launches"][k]
                        for k, v in launches.items()}
    finally:
        restore()
    out = []
    for row in rows:   # the solves ran row by row, grid by grid
        key = row["key"]
        deg, grids, k1 = R1_ROWS[key]
        jerr, jrate = JAX_R["r1_errs"][key], JAX_R["r1_rates"][key]
        mine, solves = solves[:len(grids)], solves[len(grids):]
        entry = {"row": key, "deg": deg, "grids": row["grids"],
                 "errs": row["errs"], "rates": row["rates"],
                 "jax_errs": jerr, "jax_rates": jrate,
                 "seconds": row["seconds"], "through_k1": k1,
                 "k1_launches": [s["launches"]["poisson_stiffness_action"]
                                 for s in mine]}
        out.append(entry)
        if list(row["grids"]) != list(grids):
            fail(f"slice R1: {key} grids {row['grids']}")
        for n, e, je in zip(grids, row["errs"], jerr):
            if not (math.isfinite(e) and e <= R1_ERR_FACTOR * je):
                fail(f"slice R1: {key} at {n}: error {e} > "
                     f"{R1_ERR_FACTOR} x JAX's {je}")
        for r, jr in zip(row["rates"], jrate):
            if not r >= jr - R1_RATE_SLACK:
                fail(f"slice R1: {key}: rate {r} < JAX's {jr} - "
                     f"{R1_RATE_SLACK}")
        if k1 != all(x > 0 for x in entry["k1_launches"]) or (
                not k1 and any(entry["k1_launches"])):
            fail(f"slice R1: {key}: K1 launches {entry['k1_launches']}")
    emit({"phase": "slice_R1", "nvidia_smi": smi, "rows": out,
          "optimizer": "zoom",
          "err_factor": R1_ERR_FACTOR, "rate_slack": R1_RATE_SLACK,
          "launches": launches})
    return launches


def slice_r2(dev, smi: str, tmp: str) -> dict:
    """The precision study (every section, K1's route beside the library
    policy's in sections 1 and 3)."""
    r, line = _p_cli("precision_study", [
        "--fused-kernels", "--out", os.path.join(tmp, "MIXED_PRECISION.md")])
    jax = {"accuracy": JAX_R["r2_accuracy"], "solve": JAX_R["r2_solve"],
           "adam": JAX_R["r2_adam"]}
    line.update(phase="slice_R2", nvidia_smi=smi, accuracy=r["accuracy"],
                solve=r["solve"], adam=r["adam"],
                throughput_elem_per_s=r["throughput"],
                throughput_shape=[R2_TP_BATCH, R2_TP_GRID, R2_TP_GRID],
                section_seconds=r["seconds"],
                jax=jax, f32_factor=R2_F32_FACTOR,
                accuracy_factor=R2_ACC_FACTOR, moved_below=R2_MOVED,
                bf16_factor=R2_BF16_FACTOR)
    emit(line)
    for policy in ("bf16-residual", "bf16-accum"):
        got, ref = r["solve"][policy], JAX_R["r2_solve"][policy]
        if ref < R2_MOVED and not got < R2_MOVED:
            fail(f"slice R2: the {policy} solve stayed at its start: rel "
                 f"L2 {got}, JAX's {ref}")
        if not got <= R2_BF16_FACTOR * ref:
            fail(f"slice R2: the {policy} solve's rel L2 {got} > "
                 f"{R2_BF16_FACTOR} x JAX's {ref}")
    if not r["solve"]["f32"] <= R2_F32_FACTOR * JAX_R["r2_solve"]["f32"]:
        fail(f"slice R2: the f32 solve's rel L2 {r['solve']['f32']} > "
             f"{R2_F32_FACTOR} x JAX's {JAX_R['r2_solve']['f32']}")
    for n in R2_ACC_GRIDS:
        got, ref = r["accuracy"][f"library_{n}"], JAX_R["r2_accuracy"][str(n)]
        if not got <= R2_ACC_FACTOR * ref:
            fail(f"slice R2: section 1 at {n}^2: {got} > {R2_ACC_FACTOR} "
                 f"x JAX's {ref}")
    if not all(math.isfinite(v) and v > 0
               for v in [*r["accuracy"].values(), *r["solve"].values(),
                         *r["adam"].values(), *r["throughput"].values()]):
        fail(f"slice R2: a figure is not finite: {line}")
    if line["launches"]["poisson_stiffness_action"] <= 0:
        fail("slice R2: K1 never launched")
    return line["launches"]


def r2_k1_bf16_check(dev, smi: str) -> dict:
    """The precision study's K1 route (``residual_k1``) at the shapes R2
    runs it at, section 1's and section 3's, against the plain library
    route (``residual``) on the same fields: float32 within FIELD_ATOL x
    max(1, max |plain|); bf16 within BF16_ATOL x max(1, max |plain|) of
    the plain route on the bf16 fields widened to float32 (K1's one
    rounding on the store) and of K1's own float32 result. Not on the
    path: the launch counts are restored."""
    from diffnet_tpu_torch.examples import precision_study as ps

    before = counts()
    out = {}
    shapes = [(2, n) for n in R2_ACC_GRIDS] + [(R2_TP_BATCH, R2_TP_GRID)]
    for bs, n in shapes:
        basis = ps._basis(n, dev)
        u, nu, f = ps._fields(n, bs, dev)
        ub, nub, fb = u.bfloat16(), nu.bfloat16(), f.bfloat16()
        bc = torch.zeros((n, n), device=dev)
        bc[0, :] = 1.0
        with torch.no_grad():
            r32 = ps.residual_k1(u, nu, f, basis, n, bc)
            p32 = ps.residual(u, nu, f, basis, n, bc)
            r16 = ps.residual_k1(ub, nub, fb, basis, n, bc)
            p16 = ps.residual(ub.float(), nub.float(), fb.float(), basis, n,
                              bc)
        e32 = float((r32 - p32).abs().max())
        l32 = FIELD_ATOL * max(1.0, float(p32.abs().max()))
        e16 = float((r16.float() - p16).abs().max())
        l16 = BF16_ATOL * max(1.0, float(p16.abs().max()))
        e16_32 = float((r16.float() - r32).abs().max())
        l16_32 = BF16_ATOL * max(1.0, float(r32.abs().max()))
        key = f"{bs}x{n}^2"
        out[key] = {"f32_vs_plain": e32, "f32_limit": l32,
                    "bf16_vs_plain": e16, "bf16_limit": l16,
                    "bf16_vs_f32": e16_32, "bf16_vs_f32_limit": l16_32}
        if not e32 <= l32:
            fail(f"slice R2: K1's residual at {key} {e32} off the plain "
                 f"route's > {l32}")
        if r16.dtype != torch.bfloat16 or not (e16 <= l16
                                               and e16_32 <= l16_32):
            fail(f"slice R2: K1's bf16 residual at {key}: {out[key]}")
    for name, (mod, attr, _, _) in KERNELS.items():
        setattr(mod, attr, before[name])
    emit({"phase": "slice_R2_k1_bf16", "nvidia_smi": smi, **out})
    return out


def slice_r3(dev, smi: str, tmp: str) -> dict:
    """One channel solve of the flow-past-square validation, against the
    JAX package's solution of the same case."""
    r, line = _p_cli("fps_validation", ["--cases", R3_CASE, "--h", R3_H,
                                        "--out", tmp])
    s = r["solved"][R3_CASE]
    info = s["info"]
    cuts = midline_cuts(s["u"], s["v"], s["p"], R3_H)
    scale = JAX_R["r3_u_max"]   # max |u| of JAX's solution
    errs = {k: float(np.abs(cuts[k] - np.asarray(JAX_R["r3_cuts"][k])).max()
                     / scale) for k in cuts}
    line.update(phase="slice_R3", nvidia_smi=smi, case=R3_CASE, h=R3_H,
                grid=list(s["u"].shape[::-1]),
                newton_iters=info["newton_iters"],
                jax_newton_iters=JAX_R["r3_newton_iters"],
                final_F=info["residual_history"][-1],
                jax_final_F=JAX_R["r3_final_F"],
                residual_history=info["residual_history"],
                cut_errs_rel_max_u=errs, cut_atol=R3_CUT_ATOL)
    emit(line)
    if not all(e <= R3_CUT_ATOL for e in errs.values()):
        fail(f"slice R3: midline cuts off JAX's: {errs}")
    if (JAX_R["r3_newton_iters"] < R3_NEWTON_CAP and info["newton_iters"]
            > JAX_R["r3_newton_iters"] + R3_ITERS_SLACK):
        fail(f"slice R3: {info['newton_iters']} Newton iterations, JAX "
             f"{JAX_R['r3_newton_iters']}")
    if not os.path.exists(os.path.join(tmp, f"{R3_CASE}.png")):
        fail("slice R3: no plot")
    return line["launches"]


def slice_r(dev, smi: str) -> dict:
    """The study entry points (R1-R3): the launches of each."""
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        t0 = time.perf_counter()
        r1 = slice_r1(dev, smi, tmp)
        t1 = time.perf_counter()
        r2 = slice_r2(dev, smi, tmp)
        t2 = time.perf_counter()
        r3 = slice_r3(dev, smi, tmp)
        t3 = time.perf_counter()
    return {"R1": r1, "R2": r2, "R3": r3,
            "seconds": {"R1": t1 - t0, "R2": t2 - t1, "R3": t3 - t2}}


S_K = 10                 # slice S: steps a chunk, one CUDA graph
S_EPOCHS = 3             # the first chunk runs eagerly and captures, the
                         # later chunks replay
S_LOSS_RTOL = 1e-5       # each step's loss at K = 10 against K = 1:
S_FIELD_ATOL = 1e-5      # and the final field, x max |u|. Capturable Adam
                         # (bias corrections and rate as float32 device
                         # tensors) rounds other than eager Adam (host
                         # scalars): ~1e-7 relative a step in the update,
                         # which moves a field of O(1) by ~1e-10 a step


class _EpochLog(Callback):
    """Every epoch's step losses and kernel launches."""

    def on_train_start(self, trainer, module, state):
        self.losses, self.launches, self.prev = [], [], counts()

    def on_epoch_end(self, trainer, module, state, epoch, metrics):
        self.losses += trainer.step_losses
        self.launches.append(since(self.prev))
        self.prev = counts()


def _s_fit(m, k: int, dev, loader=None) -> tuple[_EpochLog, float]:
    """S_EPOCHS epochs of Adam at ``steps_per_call=k``: the log and the
    steps/s of epochs 2 on."""
    log = _EpochLog()
    tr = Trainer(max_epochs=S_EPOCHS, optimizer="adam", learning_rate=1e-3,
                 steps_per_call=k, device=dev, callbacks=[log])
    tr.fit(m, loader)
    torch.cuda.synchronize()
    return log, 10 * (S_EPOCHS - 1) / sum(tr.epoch_times[1:])


def slice_s(dev, smi: str) -> dict:
    """``steps_per_call=S_K`` (a CUDA graph a chunk) against single steps
    on slice B's (K2) and C's (K3) modules, from the same start."""
    out = {"phase": "slice_S", "nvidia_smi": smi, "grid": [512, 512],
           "batch": 32, "batches_per_epoch": 10, "epochs": S_EPOCHS,
           "steps_per_call": S_K, "loss_rtol": S_LOSS_RTOL,
           "field_atol": S_FIELD_ATOL}
    before = counts()
    for (name, loss_type, kw), kernel in zip(
            FUSED_2D_STEPS, ("poisson_resmin_loss_grad", "poisson_energy")):
        runs, fields = {}, {}
        for k in (1, S_K):
            m = _field_module(512, 32, loss_type, **kw)
            log, fit_rate = _s_fit(m, k, dev)
            fields[k] = m.network.field.detach()
            resident = _field_module(512, 32, loss_type, **kw).to(dev)
            rlog, res_rate = _s_fit(resident, k, dev, loader=[
                _resident_batch(resident, 32, dev)] * 10)
            runs[k] = {"losses": log.losses, "fit_steps_per_s": fit_rate,
                       "resident_steps_per_s": res_rate,
                       "launches_per_epoch": [e[kernel] for e in log.launches],
                       "resident_launches_per_epoch": [
                           e[kernel] for e in rlog.launches]}
        l1, lk = (np.asarray(runs[k]["losses"]) for k in (1, S_K))
        rel = (float(np.max(np.abs(lk - l1) / np.abs(l1)))
               if len(l1) == len(lk) else math.inf)
        scale = float(fields[1].abs().max())
        field_err = float((fields[S_K] - fields[1]).abs().max()) / scale
        out[name] = {"kernel": kernel, "max_loss_rel": rel,
                     "field_err_rel_max": field_err,
                     "first_last_loss": {k: [r["losses"][0], r["losses"][-1]]
                                         for k, r in runs.items()},
                     **{f"k{k}": {key: v for key, v in r.items()
                                  if key != "losses"}
                        for k, r in runs.items()}}
    out["launches"] = launches = since(before)
    emit(out)
    for name, _, _ in FUSED_2D_STEPS:
        res = out[name]
        for k in (1, S_K):
            r = res[f"k{k}"]
            if any(n != 10 for n in r["launches_per_epoch"]
                   + r["resident_launches_per_epoch"]):
                fail(f"slice S {name} K={k}: {res['kernel']} launched "
                     f"{r['launches_per_epoch']} and "
                     f"{r['resident_launches_per_epoch']} times an epoch, "
                     "not 10")
        if not res["max_loss_rel"] <= S_LOSS_RTOL:
            fail(f"slice S {name}: the losses at K={S_K} are "
                 f"{res['max_loss_rel']} off K=1's (limit {S_LOSS_RTOL})")
        if not res["field_err_rel_max"] <= S_FIELD_ATOL:
            fail(f"slice S {name}: the field at K={S_K} is "
                 f"{res['field_err_rel_max']} x max |u| off K=1's "
                 f"(limit {S_FIELD_ATOL})")
    return launches


FUSED_2D_STEPS = (   # the resident 512^2 x 32 steps on the fused losses
    ("resmin_fused_loss_grad", "resmin",
     {"fused_kernels": True, "fused_loss_grad": True}),
    ("energy_fused", "energy", {"fused_kernels": True}))


def _adam_step(m, batch):
    """One Adam step of `m` on a batch already on the card, as a callable."""
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        m.training_loss(batch).backward()
        opt.step()

    return step


def _resident_rate(m, batch) -> float:
    """Adam steps/s of `m` on a batch already on the card: 20 steps timed
    after 3."""
    step = _adam_step(m, batch)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    return 20 / (time.perf_counter() - t0)


def _resident_batch(m, bs, dev) -> tuple:
    inputs, frc = m.dataset[0]
    return tuple(torch.from_numpy(np.broadcast_to(a, (bs,) + a.shape).copy())
                 .to(dev) for a in (inputs, frc))


def resident_steps_per_s(dev) -> dict:
    """Steps/s with the batch already on the card (no loader), Adam: the
    two 512^2 x 32 training steps on the fused losses and unfused, and
    slice G3's 8 x 256^2 NS step with and without K6."""
    out = {}
    for name, loss_type, kw in FUSED_2D_STEPS + (
            ("resmin_unfused", "resmin", {}),):
        m = _field_module(512, 32, loss_type, **kw).to(dev)
        out[name] = _resident_rate(m, _resident_batch(m, 32, dev))
    for name, fused in (("ns_vms_fused", True), ("ns_vms_unfused", False)):
        m = _ns_field_module(fused).to(dev)
        out[name] = _resident_rate(m, _resident_batch(m, G3_BATCH, dev))
    return out


def resident_step_profiles(dev) -> dict:
    """10 resident Adam steps of each fused 512^2 x 32 loss (K2's, K3's)
    under torch.profiler, read as ``_device_idle_share`` reads a solve:
    device busy and wall ms a step, the idle share and the top device
    operations (what K2 and K3 leave of a step); and the device time of
    the Galerkin projection of f (Gauss-point values, then the projection)
    that the energy step's backward makes every step (the resmin step
    projects Gauss-point values of f cached by the module)."""
    out = {}
    for name, loss_type, kw in FUSED_2D_STEPS:
        m = _field_module(512, 32, loss_type, **kw).to(dev)
        batch = _resident_batch(m, 32, dev)
        step = _adam_step(m, batch)
        for _ in range(3):
            step()
        prof = _device_idle_share(lambda _: [step() for _ in range(10)],
                                  None)
        out[name] = {"steps": 10,
                     "device_busy_ms_per_step": prof["device_busy_ms"] / 10,
                     "wall_ms_per_step": prof["wall_ms"] / 10, **prof}
    f = batch[1][..., 0].contiguous()   # the forcing, [32, 512, 512]
    out["f_projection_ms"] = cuda_ms({"f_projection": lambda: (
        fem.galerkin_project(fem.gp_eval(f, m.basis, ("N",))["N"], m.basis,
                             "N", f.shape[-2:]))})["f_projection"]
    return out


# The shape each slice runs each kernel at. D3 and F3 run K4 / K4-3D on
# every multigrid level; the fine level stands for them, since it takes the
# outer Krylov matvec on top of the V-cycle's visits that every level takes.
# J runs K1 at 32 x 64^2 in the energy's VJP and at 1 x 64^2 in the direct
# solves, which take most of its launches. M2 runs K3 and K1 (its VJP) at
# 1 x 64^2, M3 K1 at 1 x 32^2 in its CG solves, R1 at 1 x 17^2 and
# 1 x 33^2 (the finer grid stands for it). O runs K4 on the split
# V-cycle's halo'd blocks (a middle fine block, 1 x 130 x 513, stands for
# them) and K6 on 129^2's halo'd row blocks (34 rows but the first's 33)
# and on O4's 2 x 256^2 rows a rank.
SLICE_SHAPES = {
    "poisson_stiffness_action": {"A": (1, 64, 64), "B": (32, 512, 512),
                                 "S": (32, 512, 512),
                                 "C": (32, 512, 512), "D2": (1, 513, 513),
                                 "J": (1, 64, 64), "M2": (1, 64, 64),
                                 "M3": (1, 32, 32), "P1": (1, 64, 64),
                                 "P2": (1, 513, 513), "P5": (32, 64, 64),
                                 "R1": (1, 33, 33)},
    "poisson_resmin_loss_grad": {"B": (32, 512, 512), "S": (32, 512, 512)},
    "poisson_energy": {"C": (32, 512, 512), "S": (32, 512, 512),
                       "J": (32, 64, 64),
                       "M2": (1, 64, 64), "P5": (32, 64, 64)},
    "stencil_apply_2d": {"D3": (1, 513, 513), "O": (1, 130, 513)},
    "poisson_stiffness_action_3d": {"E1": (1, 17, 17, 17),
                                    "E2": (4, 64, 64, 64),
                                    "F2": (1, 129, 129, 129),
                                    "I": (1, 32, 32, 32),
                                    "P3": (1, 17, 17, 17)},
    "stencil_apply_3d": {"F3": (1, 129, 129, 129)},
    "ns_vms_residual": {"G1": (1, 129, 129), "G2": (1, 64, 64),
                        "G3": (8, 256, 256), "K": (1, 64, 64),
                        "O": (1, 34, 129), "P4": (1, 129, 129)},
}


def _kernel_call(name: str, shape, dev):
    """A call of kernel `name` on seeded random inputs of `shape`."""
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*s):
        return torch.rand(s, generator=g, device=dev)

    u, nu = rand(*shape), rand(*shape) + 0.5
    if name in ("stencil_apply_2d", "stencil_apply_3d"):
        C = rand(9 if len(shape) == 3 else 27, *shape) - 0.5
        fn = k4.apply_2d if len(shape) == 3 else k4.apply_3d
        return lambda: fn(C, u)
    if name == "poisson_stiffness_action_3d":
        tb = basis_3d(shape, False, dev)
        return lambda: k5.stiffness_action_3d(u, nu, tb)
    tb = basis_for(shape[1], shape[2], False, dev)
    if name == "poisson_stiffness_action":
        return lambda: k1.stiffness_action(u, nu, tb)
    if name == "poisson_resmin_loss_grad":
        Nf, bc = rand(*shape), (rand(*shape[1:]) > 0.9).float()
        return lambda: k2.resmin_loss_grad(u, nu, Nf, bc, tb)
    if name == "poisson_energy":
        f = rand(*shape)
        return lambda: k3.energy(u, nu, f, tb)
    v, p = rand(*shape), rand(*shape)
    # a row block of a square grid (slice O's) takes the grid's spacing
    tb = basis_for(shape[2], shape[2], False, dev)
    return lambda: k6.ns_vms_residual(u, v, p, None, None, tb, 0.01,
                                      square=shape[1] == shape[2])


def phase_path_shapes(dev, by_slice: dict) -> dict:
    """Each kernel's time at every shape its slices run it at
    (SLICE_SHAPES): ``ms`` at the slice with the most launches, and
    ``ms_by_slice``."""
    out = {}
    for name, shapes in SLICE_SHAPES.items():
        runs = {sl: by_slice[sl][name] for sl in shapes}
        sl = max(runs, key=runs.get)
        if runs[sl] <= 0:
            fail(f"{name}: no launch on its slices {runs}")
        by_shape = {}
        for shape in dict.fromkeys(shapes.values()):
            by_shape[shape] = cuda_ms(
                {name: _kernel_call(name, shape, dev)})[name]
        out[name] = {"shape": list(shapes[sl]), "slice": sl,
                     "ms": by_shape[shapes[sl]],
                     "ms_by_slice": {k: by_shape[v]
                                     for k, v in shapes.items()},
                     "launches_by_slice": runs}
    emit({"phase": "path_shapes", **out})
    return out


def main() -> int:
    dev = torch.device("cuda:0")
    smi = phase_device(dev)
    phase_build()
    k = phase_kernels(dev)
    k["times"]["poisson_stiffness_action"]["max_abs_err_bf16"] = \
        k["errs"].pop("poisson_stiffness_action_bf16")
    k4_res = phase_stencil_kernel(dev)
    k["errs"]["stencil_apply_2d"] = k4_res["err"]
    k["times"]["stencil_apply_2d"] = dict(
        k4_res["times"], ms_blocks=k4_res["block_times"])
    k5_res = phase_k5(dev)
    k["errs"]["poisson_stiffness_action_3d"] = k5_res["err"]
    k["times"]["poisson_stiffness_action_3d"] = k5_res["times"]
    k43_res = phase_stencil3d_kernel(dev)
    k["errs"]["stencil_apply_3d"] = k43_res["err"]
    k["times"]["stencil_apply_3d"] = k43_res["times"]
    k6_res = phase_k6(dev)
    k["errs"]["ns_vms_residual"] = k6_res["err"]
    k["times"]["ns_vms_residual"] = dict(
        k6_res["times"], ms_blocks=k6_res["by_block_shape"])
    phase_gradients(dev)

    paths = {}               # each path: counts set to 0 before, read after
    reset_counts()           # the 2D training path
    la = slice_a(dev)
    lb = slice_b(dev)
    lc = slice_c(dev)
    paths["training_2d"] = counts()
    reset_counts()           # the 2D linear-solver path
    ld = slice_d(dev)
    paths["solver_2d"] = counts()
    reset_counts()           # the 3D training path
    le1 = slice_e1(dev)
    le2 = slice_e2(dev)
    paths["training_3d"] = counts()
    reset_counts()           # the 3D linear-solver path
    lf = slice_f(dev)
    paths["solver_3d"] = counts()
    reset_counts()           # the flow path
    lg1 = slice_g1(dev)
    lg2 = slice_g2(dev)
    lg3 = slice_g3(dev)
    paths["flow_2d"] = counts()
    reset_counts()           # the IBN path: no kernel of the table on it
    lh = slice_h(dev, smi)
    slice_h2(dev, smi)
    paths["ibn_2d"] = counts()
    reset_counts()           # the 3D IBN path: K5 in the held-out solves
    li = slice_i(dev, smi)
    paths["ibn_3d"] = counts()
    reset_counts()           # the KL-sum UQ path: K3, K1 (VJP and solves)
    lj = slice_j(dev, smi)
    paths["uq_2d"] = counts()
    reset_counts()           # round-robin NS training: K6 per objective step
    lk = slice_k(dev, smi)
    paths["flow_rr"] = counts()
    reset_counts()           # the single-instance physics: no kernel on it
    ll = slice_l(dev, smi)
    paths["physics_2d"] = counts()
    # slice M sets the counts to 0 before each of its two paths:
    # physics_2d_immersed (K3, K1 in its VJP) and topopt_2d (K1)
    lm = slice_m(dev, smi, paths)
    # the multi-device path: launched in the group's ranks, each counting
    # from 0 before its path and read after; summed over the ranks
    paths["multi_gpu"] = ln = slice_n(dev, smi)
    # the split solvers, the split NS residual and the root-norm losses
    # over the ranks: counted as slice N's
    paths["multi_gpu_solvers"] = lo = slice_o(dev, smi)
    # the U-Nets and the IBN energy split over 'space': counted as slice
    # N's (no kernel of the table on it: cuDNN convolutions, plain energy)
    paths["multi_gpu_nets"] = lq = slice_q(dev, smi)
    reset_counts()           # the entry points: the example CLIs
    lp = slice_p(dev, smi)
    paths["entry_points"] = counts()
    reset_counts()           # the study entry points: K1 in R1 and R2
    lr = slice_r(dev, smi)
    paths["studies"] = counts()
    r2_k1_bf16_check(dev, smi)
    reset_counts()           # steps_per_call: K2, K3 (K1 in K3's VJP)
    ls = slice_s(dev, smi)   # inside CUDA graphs
    paths["training_2d_graphed"] = counts()
    total = {name: sum(p[name] for p in paths.values()) for name in KERNELS}
    emit({"phase": "main_path_launches", "total": total, **paths,
          "slice_A": la, "slice_B": lb, "slice_C": lc, "slice_E1": le1,
          "slice_E2": le2, "slice_G1": lg1, "slice_G2": lg2,
          "slice_G3": lg3, "slice_H": lh, "slice_I": li, "slice_J": lj,
          "slice_K": lk, "slice_L": ll, "slice_M": lm, "slice_N": ln,
          "slice_O": lo, "slice_Q": lq, "slice_P": lp, "slice_R": lr,
          "slice_S": ls})
    for path, names in (("training_2d", ("poisson_stiffness_action",
                                         "poisson_resmin_loss_grad",
                                         "poisson_energy")),
                        ("solver_2d", ("stencil_apply_2d",)),
                        ("training_3d", ("poisson_stiffness_action_3d",)),
                        ("solver_3d", ("poisson_stiffness_action_3d",
                                       "stencil_apply_3d")),
                        ("flow_2d", ("ns_vms_residual",)),
                        ("ibn_3d", ("poisson_stiffness_action_3d",)),
                        ("uq_2d", ("poisson_stiffness_action",
                                   "poisson_energy")),
                        ("flow_rr", ("ns_vms_residual",)),
                        ("physics_2d_immersed", ("poisson_energy",)),
                        ("topopt_2d", ("poisson_stiffness_action",)),
                        ("multi_gpu", ("poisson_stiffness_action",
                                       "poisson_resmin_loss_grad",
                                       "poisson_stiffness_action_3d")),
                        ("multi_gpu_solvers", ("stencil_apply_2d",
                                               "ns_vms_residual")),
                        ("entry_points", ("poisson_stiffness_action",
                                          "poisson_energy",
                                          "poisson_stiffness_action_3d",
                                          "ns_vms_residual")),
                        ("studies", ("poisson_stiffness_action",)),
                        ("training_2d_graphed", ("poisson_resmin_loss_grad",
                                                 "poisson_energy"))):
        for name in names:
            if paths[path][name] <= 0:
                fail(f"{name} was never launched on the {path} path")

    emit({"phase": "resident_steps_per_s",
          "steps_per_s": resident_steps_per_s(dev)})
    emit({"phase": "resident_step_profiles", **resident_step_profiles(dev)})
    by_slice = {"A": la, "B": lb, "C": lc, **ld, "E1": le1, "E2": le2, **lf,
                "G1": lg1, "G2": lg2, "G3": lg3, "I": li, "J": lj,
                "K": lk, "M2": lm["M2"], "M3": lm["M3"], "O": lo, **lp,
                "R1": lr["R1"], "S": ls}
    path = phase_path_shapes(dev, by_slice)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": total[name],
         "max_abs_err": k["errs"][name], "ms": k["times"][name]["ms"],
         "plain_ms": k["times"][name]["plain_ms"],
         "bound_ms": k["times"][name]["bound_ms"],
         "bound_by": k["times"][name]["bound_by"],
         "ms_path_shape": path[name]["ms"],
         "path_shape": path[name]["shape"],
         **{key: k["times"][name][key] for key in (
             "ms_bf16", "bound_ms_bf16", "max_abs_err_bf16", "ms_blocks")
            if key in k["times"][name]},
         # no single PyTorch call computes any of these: K1-K5 have a
         # coefficient that varies by node (nu, or the stencil planes C),
         # K6 is nonlinear in (u, v, p) with a tau per Gauss point
         "library_ms": None}
        for name, (_, _, source, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
