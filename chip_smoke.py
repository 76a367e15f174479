"""Chip smoke test of the PyTorch/CUDA port (climate_model_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

and on a machine with four (phases 1-2, then phase 16 alone):

    python3 chip_smoke.py --multicard

Phases, each printing one line with its elapsed seconds; any failure raises
and exits non-zero:

1. device   -- a CUDA device or raise; its name, count and power limit;
2. build    -- every kernel built from csrc/ with one nvcc call; the
               -Xptxas -v register, shared-memory and spill lines of each;
3. check    -- BASELINE config #3 (360x180x32, fp32, full physics), 10
               plain steps from the initial state. Each kernel variant is
               held against its plain version on the same inputs, field by
               field, within the stated bounds: the predictor and corrector
               (v wall by row index), the predictor with the wall mask and
               the corrector with the mask and the physics epilogue (from
               the same state with its moisture raised near saturation from
               a seed, so that every physics term is active; also with
               convection on). The mask variants must equal the index rule
               bit for bit, and a mask with an interior row set to 0 must
               zero v there. Planted faults: each kernel launched with one
               term left out must break a bound in one call; without
               diffusion, from the state with grid-scale noise, the bound
               of each diffused field;
4. timing   -- device time of each variant and its plain version, in
               turns (CUDA events over launches queued behind a sleep
               kernel, so that no host gap enters), with the host's time
               per call beside it, against the bound of the card; the
               device time of each launch of a call apart (the substep,
               the epilogue), from torch.profiler; beside each, the
               plans' staged_rows_per_row, scanned_cols_per_col and
               profiled_cols_per_col at its shape;
5. main     -- the run command of config #3 (``run --baseline 3 --days 0.1
               --out-every-hours 1``: 253 steps in three chunks, adaptive
               dt, hourly radiation), which takes the packed scan, with
               every launch and call counter set to 0 just before and read
               just after: one masked predictor and one epilogue corrector
               a step, no other launch and no plain physics split; cadence,
               dt and fields are checked. No file is written;
6. per-step -- the per-step path (``run_scan(make_step_fn(cfg), ...)``) for
               the first chunk of the run, from the same initial state,
               with its counters and sanity checks; the packed scan over
               the same steps, compared with it field by field; ms/step of
               both paths, in turns;
7. breakdown -- each layer of a step timed alone; the host's enqueue time
               of a packed-scan step against its device time;
8. sharded  -- BASELINE #4 (720x360x32) on its 2x4 mesh, 8 shards on the
               card: ``run --baseline 4 --days 0.05 --halo-overlap`` with
               every counter set to 0 just before and read just after (8
               shard launches of each program a step, 4 south-strip and 4
               north-strip, and the batched slab copies of the ghost
               exchange and the strips, ``halo_copies``), then the
               blocking schedule and the unsharded
               grid (``--mesh-lat 1 --mesh-lon 1``); each pair compared per
               field (SHARDED_TOL) and bit for bit. Then FAULT_STEPS steps
               from a noisy #4 state: the sound sharded run and each planted
               fault (the lon exchange left out, the lat exchange left out,
               ghosts of 2) against the unsharded grid;
9. backend  -- ``run --baseline 1`` (backend='jnp') on the card: the plain
               path, no kernel launch, finite fields;
10. io      -- in a temporary directory that it removes: phase 5's run
               with ``--out-dir`` (the NetCDF files, metrics.jsonl and the
               checkpoint read back and held against the final state, and
               ms/step with output beside phase 5's); the same horizon run
               in two parts across a checkpoint, equal to it bit for bit
               in every State field, with one metrics timeline and the same
               last NetCDF file; planted faults (a resume with the
               radiation cache zeroed must differ, a resume with ``--diff``
               changed must be refused naming the field, and with
               ``--force-resume`` must record the branch); #4's blocking
               run on its 2x4 mesh in two parts, the checkpoint saved from
               the gathered state, equal to the continuous run bit for bit;
               the host ms of save_checkpoint, load_checkpoint and
               NCWriter.write. It prints whether matplotlib imports, which
               gates nothing.
11. bench   -- the bench slice through cli.main: ``bench --baseline 3``
               (its JSON line; every counter set to 0 just before and read
               just after: one masked predictor and one epilogue corrector
               a step of its four chunks; its step time at least
               STEP_FLOOR of the two kernels' device time from phase 4, and
               0 < vs_hbm_roofline <= 1.05), ``bench --micro`` (pred_ms and
               corr_ms within MICRO_TOL of phase 4's), ``profile`` on the
               kernels and on the plain splits with a trace written,
               ``bench --stability`` over 1050 steps, the budget identities
               at #3 on the plain backend, ``bench --scaling --baseline 4
               --halo-overlap`` (counted: 8 shard launches of each program
               a step, 4 south-strip and 4 north-strip), and ``run
               --stepper euler`` / ``rk4`` at 64x32x8 with the run's sanity
               checks;
12. jnp mesh -- BASELINE #4 on the plain backend (``run --baseline 4
               --backend jnp``, JNP_MESH_STEPS steps) on its 2x4 mesh in one
               process: the per-operator halo path (``shard_map``, 8 shard
               threads in lockstep), GSPMD ``auto`` (the global program on
               the card) and the unsharded grid, each with every counter
               set to 0 just before and read just after (no kernel
               launch); ``shard_map`` against unsharded field by field
               (JNP_MESH_TOL, and whether bit for bit), ``auto`` equal to
               unsharded bit for bit, the run's sanity checks; then
               JNP_FAULT_STEPS steps from the noisy #4 state, sound and
               with each planted fault (the lon exchange left out, the lat
               exchange left out, the v wall on every lat shard), each of
               which must break a bound; ms/step of the three runs and the
               shifts a step;
13. gate    -- the whole model on the card, the kernel path (the packed
               scan, backend='pallas') against the plain path
               (backend='jnp') from the same initial state on one device,
               as the reference's on-device gate runs it: config #3 for 110
               steps at its hourly cadence (a radiation refresh at step
               105) and config #5 for 12 steps with radiation every 4; every
               State field within GATE_TOL, each run counted (n masked
               predictors and n epilogue correctors on the kernel path, no
               launch on the plain path); planted faults on the kernel path
               (the radiation refresh after step 0 skipped, the epilogue
               without the turbulence) must each break a bound at both
               configs;
14. baseline5 -- BASELINE #5 (1440x720x32) through the run command:
               unsharded for 0.25 days (its sanity checks, its last metrics
               record printed beside the reference's first line of
               out_clim_025/metrics.jsonl), then its 4x8 mesh (32 shards on
               the card) with halo overlap and blocking against the
               unsharded grid over B5_STEPS steps, counted as phase 8 counts
               #4 (32 shard launches of each program a step, 24 south-strip
               and 24 north-strip); FAULT_STEPS steps from a noisy #5 state,
               sound and with the lat exchange left out; the masked
               predictor and the epilogue corrector at #5's grid against
               their plain versions and timed beside their bound; ms/step
               and peak device memory of each run;
15. climate -- the reference's long-run gates at their own configs and
               thresholds (tests/integration/test_climate_sanity.py,
               test_milestone2_fullsize.py), each run counted as phase 13
               counts its own: energy and water closure at 96x48x8 over
               16 chunks of 50 steps on both backends, the approach to
               equilibrium at 60x30x10 over 60 days and fine-grid
               stability at 180x90x16 over 2000 steps on the kernel path
               (CLIMATE_GATES); the masked predictor and the epilogue
               corrector against their plain versions at those three
               shapes, each with planted faults that must break a bound,
               and timed; BASELINE #2 for 500 steps on its plain backend
               with the milestone-2 invariants; ``run --baseline 3 --topo
               continents --days 30`` (CONT_ARGV), its record at step 632
               against the reference's first line of
               out_clim_continents/metrics.jsonl, its days 20-30 against
               bands pinned from the reference's series
               (CONT_WINDOW_BANDS) and the closure gate over its 30 days;
17. compiled -- the compiled chunk (``graphs.py``: CUDA graphs of the
               step, which every run of the phases above takes on the
               card but phase 13's, whose planted faults replace names
               the eager step calls) against the eager loop
               (``graphs=False``): #3 through ``cli.run`` in chunks of
               COMPILED_CHUNK steps, each chunk's dt COMPILED_DT_SCALE
               times the last's and the radiation refresh at another step
               of each chunk, eager and compiled in turns, every field
               and ``t`` bit for bit, counted alike, four graphs captured
               a run (none after a dt change); the planted faults
               (COMPILED_FAULTS: replays that keep the capture-time dt,
               the same parity replayed twice) must each break it; then
               COMPILED_CASES (#4 on 2x4 in both schedules, #5 unsharded
               and on 4x8 in both), eager against compiled likewise. For
               each: ms/step after the first chunk, the captures' seconds
               and pool, peak device memory, and over one more chunk the
               host's enqueue ms a step, the device's busy ms a step and
               idle share, and each kernel's device ms in the captured
               step (``torch.profiler``);
18. rk4      -- the RK4 stage kernel (``rk4_stage_kernel<1..4>``) at #3
               in fp32: each stage kind on the plain chain's inputs
               against ``fs.rk4_stage_plain``, the next stage state and the
               accumulator field by field (RK4_TOL, RK4_ACC_TOL), the wall
               mask equal to the index rule bit for bit; the four stages
               chained against the plain RK4 step (RK4_STEP_TOL); the
               planted faults (RK4_FAULTS: k2 weighted 1 in place of 2,
               COLP_new from the stage state in place of the t_n state)
               must each break a bound; then #3 with ``time_stepping =
               "rk4"`` through ``cli.run`` in chunks of COMPILED_CHUNK steps
               (dt changes, radiation refreshes), eager and compiled in
               turns, bit for bit and counted alike (four stage launches
               and one epilogue a step, nothing else), with ms/step, the
               host's enqueue, the device's busy ms and idle share and each
               kernel's device ms in the captured step; each stage kind
               and the epilogue alone timed against its plain version, in
               turns, beside its bound, for the ``kernels`` line;
19. halo copy -- the ghost exchange's batched slab copy
               (``kernels/halo_copy.py``) on the blocks of ranks 0 and 2 of
               #5 on 2x2 with halo overlap (32x363x726 and 363x726, fp32,
               noise from a seed): every pack and unpack of the column
               refresh and the row exchange of 12 and of 6 fields, the seam
               strip's cut and its splices of 6 and 9 fields, then float64
               slabs, runs misaligned to 16 bytes and more pairs than a
               launch takes; each the port's call against the per-slab
               ``copy_`` on the same inputs, every destination set to a
               sentinel before each, bit for bit, its launches and slabs
               counted from 0 (a launch for every 48 slabs); each rank's
               step of copies counted from 0 (``halo_copies``: 13
               launches, 141 slabs) and timed against its per-slab copies,
               in turns, beside the bound of its bytes read and written,
               for the ``kernels`` line;
16. across cards -- only with ``--multicard``, which needs four cards: the
               paths across ranks, one card per rank under NCCL, each held
               against the same grid on one card in this process, read back
               from the ranks' checkpoint sets. The ranks are started with
               ``torchrun --standalone --nproc-per-node 4``, each launch in
               a session of its own that is killed after MC_TIMEOUT_S.
               (h) the shard-local and seam-strip variants at the blocks
               of #4 and #5 on 2x2 and of #4 on 1x4 and 4x1 against their
               plain versions, timed (MC_KERNEL_CASES);
               (a) ``-m climate_model_tpu_torch run --baseline 4 --mesh-lat
               2 --mesh-lon 2 --multihost`` over phase 8's 258 steps with
               ``--out-dir``, with halo overlap and blocking, bit for bit,
               with one checkpoint file a rank and rank 0's NetCDF and
               metrics files; then one launch of this script as the rank
               worker (``--rank-worker``), through ``cli.run`` after
               ``init_multihost``, counted: (b) #5 on 2x2 over 150 steps in
               both schedules and (c) #4 on 1x4 blocking and 4x1 with
               overlap over 50, bit for bit, each mesh then clocked for the
               exchange's host and device ms a step; (e) #4 on the plain
               backend on 2x2 over 20 steps, ``shard_map`` (messages at
               every shift) within JNP_MESH_TOL and ``auto`` (DTensors)
               within MC_AUTO_TOL; (f) (a)'s overlap run split
               at step 129 and resumed on the same ranks, bit for bit, its
               set loaded in one process equal to the gathered state, and a
               set without ``.p2`` refused; (d) planted faults from the
               noisy #4 state (MC_FAULTS, MC_JNP_FAULT on ``shard_map`` and
               MC_AUTO_FAULT on ``auto``), each of which must break a bound,
               and the lat exchange after the predictor left out, a
               reading; (g) ``bench
               --scaling --multihost`` for #4 with halo overlap and #5 on
               2x2 namelists, one JSON line each from rank 0 alone. The
               packed runs across ranks are the compiled chunk, their
               NCCL posts captured in the step's graph: each start line
               and each rank's recorded path must say so (MC_COMPILED);
               the exchange clock's runs are eager. The default run
               prints a line saying that phase 16 needs ``--multicard``.

``check_against`` holds the substep and epilogue kernels against another
checkout's (the parent commit's) bit for bit at every shape of
AGAINST_CASES and times both in turns; ``tools/kernel_bitwise.py`` runs
it. Phase 3 also holds the
epilogue's momentum terms on a windy state
(MOMENTUM_FAULTS), the epilogue on TALL_NZ levels, and the shard-local and
seam-strip variants on blocks of the noisy #4 state (CHECK_BLOCKS); phase 4
times those variants at #4's 2x4 shapes. The line before last is the total,
the last line the JSON verdict. The port
imports no JAX, and neither does this script.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as tdist

from climate_model_tpu_torch import cli, model, trace
from climate_model_tpu_torch.bench.micro import device_ms, launch_ms, sync
from climate_model_tpu_torch.bench.roofline import (
    EPILOGUE_FLOPS_PER_POINT, bound_ms, substep_bound_ms)
from climate_model_tpu_torch.bench.stability import probe_stability
from climate_model_tpu_torch.core.config import (GridConfig, ModelConfig,
                                                 NumericsConfig,
                                                 PhysicsConfig,
                                                 baseline_config,
                                                 default_diffusion,
                                                 resolve_rad_interval)
from climate_model_tpu_torch.core.grid import adaptive_cfl_dt, round_to
from climate_model_tpu_torch.core.init import initialize
from climate_model_tpu_torch.core.state import State
from climate_model_tpu_torch.dist import comm, halo, packed_halo, sharding
from climate_model_tpu_torch.dist.mesh import Mesh, barrier, make_mesh
from climate_model_tpu_torch.dist.packed_halo import SeamStrip, row_mask
from climate_model_tpu_torch.dycore import boundaries as bc
from climate_model_tpu_torch.dycore.operators import diagnose_pressure
from climate_model_tpu_torch.dycore.stepper import run_scan, step_matsuno
from climate_model_tpu_torch.io.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
from climate_model_tpu_torch.io.convert import (state_from_numpy,
                                                state_to_numpy)
from climate_model_tpu_torch.io.metrics import diagnostics
from climate_model_tpu_torch.io.netcdf import NCWriter
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.kernels import halo_copy as hc
from climate_model_tpu_torch.model import (make_chunk_runner, make_step_fn,
                                           phys_epilogue_tuple)
from climate_model_tpu_torch.physics import (microphysics, radiation,
                                             surface, turbulence)
from climate_model_tpu_torch.physics.thermo import qsat_water

MAIN_ARGV = ["run", "--baseline", "3", "--days", "0.1",
             "--out-every-hours", "1"]

# Per-field bounds on max|kernel - plain| for ONE substep at config #3 in
# fp32, from the state 10 plain steps in. The kernel and the plain version
# differ only by fp32 rounding in another order (FMA contraction, sequential
# k-sums). Each bound is 2.5-4x the largest error measured on an H100 (u
# 1.3e-4 m/s, v 3.2e-5 m/s, pott 6.1e-5 K (2 ulp at 300 K), qv 1.4e-9, qc 0,
# colp 7.8e-3 Pa (1 ulp at 9e4 Pa)), and well below what one term of the
# substep adds in one step: phase 3 launches the kernel with the radiative
# source left out, then with diffusion left out, and requires each to
# break a bound (PLANTED_FAULTS). The same bounds hold one substep from the
# state with grid-scale noise (rough_state), where the kernel without
# diffusion must break the bound of each of DIFFUSED.
FIELD_TOL = {"u": 5e-4, "v": 1e-4, "pott": 1.5e-4, "qv": 5e-9, "qc": 1e-10,
             "colp": 0.03}
PLANTED_FAULTS = {"with_rad=False": {"with_rad": False},
                  "with_diff=False": {"with_diff": False}}
DIFFUSED = ("u", "v", "pott", "qv")

# Per-field bounds on max|kernel - plain| for ONE call of the corrector with
# the physics epilogue at config #3 in fp32, from the moist check state
# (moist_state). Each is 3.0-3.8x the error measured on an H100 (u 1.26e-4
# m/s, v 3.09e-5 m/s, pott 7.9e-4 K, qv 3.08e-7, qc 2.99e-7, colp 7.8e-3
# Pa, tsurf 3.05e-5 K, rain 6.6e-6 kg/m2, soil_moist 4.7e-9 m). pott and
# the moisture carry the saturation adjustment's sensitivity to the Exner
# factor of the new colp, a difference of two nearly equal fp32 products
# rounded in another order (FMA). One call suffices for the planted faults:
# the epilogue without the surface, the turbulence or the microphysics each
# breaks a bound (EPI_FAULTS).
EPI_TOL = {"u": 4e-4, "v": 1e-4, "pott": 2.5e-3, "qv": 1e-6, "qc": 1e-6,
           "colp": 0.03, "tsurf": 1e-4, "rain": 2e-5, "soil_moist": 1.5e-8}
EPI_FAULTS = ("surface", "turbulence", "microphysics")
# Bounds on max|packed scan - per-step path| after the first chunk (105
# steps) from the initial state: the same model, the epilogue kernel in
# place of the plain physics splits. 3.0-3.6x the difference measured on an
# H100 (u 1.87e-3 m/s, v 1.95e-3 m/s, pott 7.6e-4 K, qv 9.8e-8, colp 8.6e-2
# Pa, tsurf 1.22e-4 K, soil_moist 2.8e-9 m; qc and rain 0: the run's air
# stays below saturation for its first hour).
PATHS_TOL = {"u": 6e-3, "v": 6e-3, "pott": 2.5e-3, "qv": 3e-7, "qc": 1e-10,
             "colp": 0.3, "tsurf": 4e-4, "rain": 1e-10, "soil_moist": 1e-8}
SEED = 5                         # the generator of the check states

# The epilogue's momentum terms (surface drag and K-diffusion of u and v)
# are read on a state with strong winds near the surface and vertical shear
# (windy_state): without the surface, and without the turbulence, u and v
# must each break their EPI_TOL bound in one call, and the sound kernel
# must stay within every bound.
MOMENTUM_FAULTS = ("surface", "turbulence")
# A column taller than one warp's lanes (three levels a lane): config #3's
# physics on a small grid with TALL_NZ levels, from the moist state. With
# layers 3x thinner, the Exner factor's difference of two nearly equal
# products (see EPI_TOL) loses 3x more to rounding: an H100 read pott
# 3.05e-3 K, qv 1.42e-6, qc 1.07e-6, rain 5.20e-5, soil_moist 2.33e-8 (u
# 7.8e-5, v 3.6e-5, tsurf 3.05e-5, colp 0). TALL_TOL is 3.3-4.7x these
# and EPI_TOL's bounds elsewhere.
TALL_NZ = 96
TALL_GRID = (64, 32)             # nx, ny
TALL_TOL = dict(EPI_TOL, pott=1e-2, qv=5e-6, qc=5e-6, rain=2e-4,
                soil_moist=1e-7)

# BASELINE #4 (720x360x32, full physics, adaptive dt) on its 2x4 mesh,
# every shard on the one card: the halo-overlap schedule through the run
# command (the main path of this slice; the preset itself, as the
# reference's, leaves halo_overlap off), the blocking schedule, and the
# same grid unsharded (the 1x1 override), all from the initial state over
# 0.05 days (258 steps at 16.7 s, three chunks).
SHARDED_ARGV = ["run", "--baseline", "4", "--days", "0.05",
                "--out-every-hours", "0.4", "--halo-overlap"]
BLOCKING_ARGV = SHARDED_ARGV[:-1]
UNSHARDED_ARGV = BLOCKING_ARGV + ["--mesh-lat", "1", "--mesh-lon", "1"]
SHARD_PARTS = ("shard", "south_strip", "north_strip")
# The shard-local and seam-strip variants are checked on blocks cut from a
# #4-sized moist state with grid-scale noise: (name, mesh, shard).
CHECK_BLOCKS = (("interior", (4, 4), 5),      # ghosts on all four sides
                ("polar-edge", (2, 4), 1),    # the south wall, no ghosts
                ("lon-seam", (2, 4), 4))      # west ghosts across lon 0
# Bounds on max|kernel - plain| over the block's interior (a strip: the
# interior rows it keeps) for one call: the single-device bounds, which the
# same arithmetic keeps to (an H100 read at most u 1.34e-4, v 3.33e-5,
# pott 8.85e-4 with the epilogue, 6.1e-5 without, qv 3.48e-7, qc 3.41e-7,
# rain 3.56e-6), but for the predictor's qc: the check state has cloud
# water (the #3 check state has none there), and it read 1.164e-10, one
# ulp; its bound is 4.3x that.
SHARD_TOL = dict(FIELD_TOL, qc=5e-10)
SHARD_EPI_TOL = EPI_TOL
# Bounds on max|sharded run - unsharded run|, after the 258 steps of #4
# from the initial state and after FAULT_STEPS steps from the noisy #4
# check state (noisy4). An H100 read 0 in every field in both cases, both
# schedules: bit for bit, as the shard kernels do the same fp32 operations
# per point on the same values and radiation is column-local. Each bound
# is 3-6 fp32 ulp of the field's largest values, so a run passes only if
# it loses no more than the last bits of a few cells. Each planted fault
# (from the noisy state, where a fault at a seam is not lost to rounding)
# must break one, but for the lon exchange left out after the predictor
# only: that read 0 too, and is printed, not gated (PERF.md, Findings).
SHARDED_TOL = {"u": 2e-5, "v": 2e-5, "pott": 1e-4, "qv": 5e-9, "qc": 3e-10,
               "colp": 0.03, "tsurf": 1e-4, "rain": 5e-8,
               "soil_moist": 5e-8}
FAULT_STEPS = 20
# ... and BASELINE #1 (backend='jnp') on the card for 0.05 days: the plain
# per-step path, no kernel launch.
BACKEND_ARGV = ["run", "--baseline", "1", "--days", "0.05"]
# Phase 12 (jnp mesh): BASELINE #4 on the plain backend over 0.00387 days,
# 20 steps at 16.715 s in two chunks of 10, radiation refreshed at step 0:
# on its 2x4 mesh in shard_map mode (the preset's), in auto mode, and
# unsharded. The shard_map run takes 0.68-0.89 s a step
# on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md).
JNP_MESH_ARGV = ["run", "--baseline", "4", "--backend", "jnp", "--days",
                 "0.00387", "--out-every-hours", "0.04645"]
JNP_AUTO_ARGV = JNP_MESH_ARGV + ["--sharding-mode", "auto"]
JNP_UNSHARDED_ARGV = JNP_MESH_ARGV + ["--mesh-lat", "1", "--mesh-lon", "1"]
# Bounds on max|shard_map run - unsharded run| of the plain backend, after
# those steps and after JNP_FAULT_STEPS steps from the noisy #4 state. An
# H100 read 0 in every field in both cases (30 and 10 steps): bit for bit,
# as the shifts copy values and every reduction runs along a column. The
# bounds are the sharded packed scan's (SHARDED_TOL, 3-6 fp32 ulp of each
# field's largest values, above the reference's fp32 error scale against
# itself); each planted fault broke them by 3 to 11 orders of magnitude.
JNP_MESH_TOL = dict(SHARDED_TOL)
JNP_FAULT_STEPS = 3
# Phase 13 (gate): the whole model, the kernel path against the plain path
# on the card, from the same initial state on a 1x1 mesh, as the reference's
# tests/tpu/test_tpu_numerics.py::test_full_model_packed_matches_jnp_on_device
# runs it: (baseline, steps, radiation every n steps; None: the preset's
# hourly cadence, 105 steps at #3).
GATE_RUNS = ((3, 110, None), (5, 12, 4))
# The reference's bounds on max|pallas - jnp| after those steps, its fp32
# error scale against itself (tests/tpu/test_tpu_numerics.py:26-39). No
# bound of GATE_TOL is above it.
REF_GATE_TOL = {"u": 0.02, "v": 0.02, "colp": 1.0, "pott": 0.01, "qv": 2e-6,
                "qc": 2e-6, "tsurf": 0.01, "rain": 1e-5, "soil_moist": 1e-7,
                "dpottdt_rad": 2e-7, "swflx_sfc": 0.05, "lwflx_sfc": 0.05}
# Bounds on max|kernel path - plain path| by baseline, each 4.0-4.8x what an
# NVIDIA H100 80GB HBM3 at 700 W measured (PERF.md, PR 11). #3 after 110
# steps: u 2.244e-3 m/s, v 1.985e-3, colp 9.375e-2 Pa (12 ulp at 9e4 Pa),
# pott 1.221e-3 K, qv 1.483e-7, tsurf 1.221e-4 K, soil_moist 2.794e-9 m,
# dpottdt_rad 5.0e-9 K/s, swflx_sfc 4.272e-4 W/m2, lwflx_sfc 1.450e-3
# W/m2 (the reference read the same scale on its chip: u 2.3e-3, v 2.7e-3,
# colp 0.13, pott 9.8e-4, qv 2e-7, dpottdt_rad 1.7e-8, lwflx 1.9e-3). #5
# after 12 steps: u 6.701e-4, v 2.342e-4, colp 9.375e-2, pott 5.493e-4,
# qv 1.234e-8, tsurf 9.155e-5, soil_moist 9.313e-10, dpottdt_rad 4.849e-9,
# swflx_sfc 2.441e-4, lwflx_sfc 8.392e-4. qc and rain read 0 at both (the
# air stays below saturation over these steps), and their bound is
# PATHS_TOL's for a 0 reading. A table for each config: #5's 12 steps grow
# a tenth of #3's 110 in most fields, and one table at #3's scale would
# hold the epilogue without turbulence at #5 within its pott bound.
GATE_TOL = {
    3: {"u": 1e-2, "v": 8e-3, "colp": 0.4, "pott": 5e-3, "qv": 6e-7,
        "qc": 1e-10, "tsurf": 5e-4, "rain": 1e-10, "soil_moist": 1.2e-8,
        "dpottdt_rad": 2e-8, "swflx_sfc": 2e-3, "lwflx_sfc": 6e-3},
    5: {"u": 3e-3, "v": 1e-3, "colp": 0.4, "pott": 2.5e-3, "qv": 5e-8,
        "qc": 1e-10, "tsurf": 4e-4, "rain": 1e-10, "soil_moist": 4e-9,
        "dpottdt_rad": 2e-8, "swflx_sfc": 1e-3, "lwflx_sfc": 4e-3}}
# the planted faults of the kernel path, each of which must break a bound at
# both configs; the stale radiation caches must break dpottdt_rad and one
# of the surface fluxes
GATE_FAULTS = ("radiation refresh after step 0 skipped",
               "epilogue without the turbulence")
STALE_MUST_BREAK = ("dpottdt_rad", ("swflx_sfc", "lwflx_sfc"))
# Phase 14 (baseline5): BASELINE #5 unsharded over the horizon of the first
# line of the reference's out_clim_025/metrics.jsonl (0.25 days, 2612 steps
# at 8.267 s), in two chunks so that ms/step after the first is read; that
# line, whose wall_s and grid_points_per_s are a TPU's and not compared:
B5_DAY_ARGV = ["run", "--baseline", "5", "--mesh-lat", "1", "--mesh-lon",
               "1", "--days", "0.25", "--out-every-hours", "3"]
REF5_FIRST_LINE = {"step": 2612, "mean_colp": 90956.4140625,
                   "mean_pott": 309.9237060546875,
                   "total_water": 7001498382761984.0,
                   "max_wind": 10.324687004089355,
                   "toa_net_sw": 249.9434051513672,
                   "olr": 243.61082458496094}
# ... then its 4x8 mesh in one process, blocking (the preset) and with halo
# overlap, against the unsharded grid: 150 steps at 8.267 s in three chunks
# of 50, radiation refreshed at step 0 (every 435 steps).
B5_ARGV = ["run", "--baseline", "5", "--days", "0.01436",
           "--out-every-hours", "0.115"]
B5_STEPS = 150
B5_OVERLAP_ARGV = B5_ARGV + ["--halo-overlap"]
B5_UNSHARDED_ARGV = B5_ARGV + ["--mesh-lat", "1", "--mesh-lon", "1"]

# the counters of the plain physics splits (every other counter of
# read_counts is a kernel's)
PLAIN_COUNTERS = ("radiation_refreshes", "surface_calls", "turbulence_calls",
                  "microphysics_calls")
# Phase 10 (io): config #3 with its files, continuous and split at half the
# horizon (step 127 of 253, between the radiation refreshes at steps 105
# and 210, so the resumed run needs the saved caches), and #4's blocking
# run on its 2x4 mesh split at half its horizon. Bit for bit equality holds
# because dt does not change across a resume: at these calm winds the
# adapted dt equals the initial dt in fp32, at #3 (34.148 s) and at #4
# (16.715 s).
IO_SPLIT_DAYS = 0.05
IO4_SPLIT_DAYS = 0.025
IO_TIMING_REPS = 3
NC_FIELDS = {"UWIND": "u", "VWIND": "v", "POTT": "pott", "QV": "qv",
             "QC": "qc", "COLP": "colp", "RAIN": "rain", "TSURF": "tsurf",
             "SOILMOIST": "soil_moist"}

# Phase 11 (bench): the bench and profile subcommands on the card, each
# through cli.main with its one JSON line (or table) read back. bench's
# defaults are 50 steps a chunk, one warm-up chunk and the best of 3.
BENCH_ARGV = ["bench", "--baseline", "3"]
BENCH_CHUNKS = 1 + 3
MICRO_ARGV = ["bench", "--micro", "--baseline", "3"]
PROFILE_ARGV = ["profile", "--baseline", "3"]
PROFILE_JNP_ARGV = PROFILE_ARGV + ["--backend", "jnp"]
STABILITY_ARGV = ["bench", "--stability", "--baseline", "3", "--steps",
                  "1050", "--chunk", "105"]
SCALING_ARGV = ["bench", "--scaling", "--baseline", "4", "--steps", "10",
                "--halo-overlap"]
SCALING_RUNS = 1 + 3             # measure_scaling: a warm run, best of 3
STEPPER_ARGV = ["run", "--nx", "64", "--ny", "32", "--nz", "8", "--days",
                "0.05", "--stepper"]
# bench's step is the two kernels' device time and more: a wall time under
# STEP_FLOOR of it means the enqueue was timed. bench --micro times the
# same kernels as phase 4, chained from the initial state: within
# MICRO_TOL of phase 4's device ms.
STEP_FLOOR = 0.95
MICRO_TOL = 0.15
# The budget identities at #3 on the plain backend in fp32, for more than
# one radiation interval, with the bounds of the reference's
# tests/tpu/test_budget_identity_tpu.py (each global fp32 sum carries
# ~1e-7 of the total in reduction error).
BUDGET_STEPS = 120

# Main-path sanity bounds (the repo's verification recipe for a short run):
MAX_WIND = 100.0                 # m/s; beyond it the run is blowing up
MEAN_COLP = (90_000.0, 91_000.0)  # Pa, area-weighted mean COLP
POTT_RANGE = (280.0, 340.0)      # K, every cell
MASS_DRIFT = 1e-6                # relative drift of sum(colp*area)

STATE_FIELDS = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc")

# Phase 15 (climate): the reference's long-run gates on the card, at their
# own configs and thresholds (tests/integration/test_climate_sanity.py,
# tests/integration/test_milestone2_fullsize.py), on backend='pallas' (the
# packed scan) unless named. Each gate: (grid, radiation every n steps,
# horizontal diffusion; None: default_diffusion(nx)). Closure (:56-90): 16
# chunks of 50 steps, also on backend='jnp' as the reference's config runs
# it. Equilibrium (:94-143): 20 chunks of 3 days. Fine grid (:147-169):
# probe_stability over 2000 steps in chunks of 200, wind limit 150 m/s.
CLIMATE_GATES = {"closure": ((96, 48, 8), 4, 1e4),
                 "equilibrium": ((60, 30, 10), 12, None),
                 "fine grid": ((180, 90, 16), 6, None)}
CLOSURE_RUN = (16, 50)               # chunks, steps a chunk
EQUILIBRIUM_RUN = (20, 3.0)          # chunks, days a chunk
FINE_RUN = (2000, 200, 150.0)        # steps, steps a chunk, wind limit
# the closure gate's bounds (:81-90): |d(energy)/dt - (toa_net_sw - olr)|
# of each chunk and |their mean| in W/m2, and |water change - integrated
# evaporation| / integrated evaporation
CLOSURE_BOUNDS = {"resid": 12.0, "mean": 5.0, "water": 0.02}
# Milestone #2 (test_milestone2_fullsize.py:35-52): BASELINE #2 on its
# own backend (plain) for 500 steps: finite POTT, max|u|, max|v| under the
# wind bound, relative dry-mass drift under the mass bound, qv and qc >= 0,
# POTT strictly inside the range.
# The epilogue's bounds at the gates' shapes. EPI_TOL was pinned at #3's dt
# (34.148 s); the physics the epilogue adds in a call scales with dt (7.3x
# at 60x30x10), and so does its fp32 rounding: there the plain version in
# fp32 reads rain 1.98e-5 kg/m2 off the same call in fp64 on an H100 (2.43e-5
# on the CPU), and the kernel 2.40e-5 off the plain version, over EPI_TOL's
# 2e-5 (PERF.md). Each field's bound at a shape is the larger of its
# EPI_TOL and this factor times the plain version's own fp32 error there,
# read in the same call; the planted faults must still break a bound.
FP32_ERROR_FACTOR = 3.0
M2_STEPS = 500
M2_BOUNDS = {"wind": 150.0, "mass": 1e-5, "pott": (180.0, 500.0)}
# BASELINE #3 over the continents for 30 days through the run command: 121
# chunks, 120 of 632 steps at dt 34.148 s and one of 52 to the horizon.
CONT_ARGV = ["run", "--baseline", "3", "--topo", "continents", "--days",
             "30", "--out-every-hours", "6", "--no-nc"]
# Its bands, pinned from the reference's year of the same command on its
# kernels (out_clim_continents/metrics.jsonl; 1565 records to day 365)
# before the port's first 30-day run on the card. (1) The reference's first
# line, at step 632: mean COLP within 4 fp32 ulp (0.0078125 Pa each at
# 88,696 Pa), mean POTT within 0.01 K, TOA SW and OLR within 0.5 W/m2, max
# wind within 0.5 m/s, total water within 0.1 %. The line's wall_s and
# grid_points_per_s are a TPU's and not compared.
CONT_FIRST_LINE = {"step": 632, "mean_colp": 88696.2109375,
                   "mean_pott": 309.90771484375,
                   "toa_net_sw": 243.19432067871094,
                   "olr": 239.79310607910156,
                   "max_wind": 34.7733268737793,
                   "total_water": 6393746551734272.0}
CONT_FIRST_TOL = {"mean_colp": 4 * 0.0078125, "mean_pott": 0.01,
                  "toa_net_sw": 0.5, "olr": 0.5, "max_wind": 0.5,
                  "total_water": 1e-3 * 6393746551734272.0}
# (2) Days 20-30: the reference's 40 records at steps 51,192-75,840 (it
# kept dt at 34.148 s to day 66, so the port's records fall on the same
# steps while its winds stay under MAX_WIND). Each band from the
# reference's series over that window (window_figures of its records):
# - mean_pott, the window's mean: inside the reference's range of mean POTT
#   over the window, 310.860-312.174 K (its mean 311.535; the climate still
#   warms 0.13 K/day there);
# - toa_imbalance, the mean of toa_net_sw - olr: the reference's 4.230
#   W/m2 within one standard deviation of its series over the window,
#   2.261;
# - rain_over_evap, the rain accumulated over the window over the mean
#   evaporation: the reference's 0.9406 within the relative standard
#   deviation of its evaporation rate over the window, 3.54 %;
# - water_gain, total water at step 75,840 less at step 632: the
#   reference's 1.2337e16 kg within the same 3.54 % (the gain is integrated
#   evaporation);
# - mean_colp_lo / _hi, the least and the largest mean COLP of the window's
#   records: inside the reference's 88,696.195-88,696.219 Pa widened by 4
#   fp32 ulp on each side.
CONT_WINDOW_STEPS = (51192, 75840)
CONT_WINDOW_BANDS = {
    "mean_pott": (310.8603820800781, 312.1740417480469),
    "toa_imbalance": (1.9691319228466604, 6.491362309331073),
    "rain_over_evap": (0.9073108929178108, 0.973970624099827),
    "water_gain": (1.1899793794976048e16, 1.2774066397329104e16),
    "mean_colp_lo": (88696.1640625, 88696.25),
    "mean_colp_hi": (88696.1640625, 88696.25)}
# The continents' sanity ranges (sanity() with these in place of MEAN_COLP
# and POTT_RANGE, which are the gaussian mountain's): the reference's mean
# COLP over its year, 88,695.742-88,696.227 Pa, widened by 4 fp32 ulp on
# each side; every cell's POTT in its day-365 state
# (out_clim_continents/restart.npz), 218.08-428.54 K over the 4.3 km
# plateau and the winter pole, with about 20 K on each side.
CONT_MEAN_COLP = (88695.7109375, 88696.2578125)
CONT_POTT_RANGE = (200.0, 450.0)
# The year over the continents (run outside this script, in legs; see
# tools/climate_year.py): annual_figures of the port's metrics against
# bands pinned from the reference's year before the port's first leg ran.
# TOA imbalance over days 120-365: its +0.0777 W/m2 within 3x the standard
# error of the mean from its 10-day block means, detrended by differences
# (0.1715); mean POTT over the same days, 312.8675 K within 3x its 0.0403;
# rain/evap over days 180-365, 1.0201 within 3x the standard error of its
# 15-day block ratios (0.0246); the drift of mean COLP, first record to
# last, at most twice its -0.461 Pa (5.2e-6 of it); peak wind 198.4 m/s
# within 25 %, about the 171-204 m/s span of the committed runs at 1-2 deg
# (docs/STATUS.md); the least dt over the first, 0.808, within the wind
# band carried through the CFL bound (dt ~ 1 / wind), up to 1.
REF_YEAR = {"toa_mean": 0.07771190451510125, "toa_std": 3.975649896469632,
            "pott_mean": 312.8675337352788,
            "rain_over_evap": 1.0200824801251591, "colp_drift": -0.4609375,
            "peak_wind": 198.44668579101562,
            "min_dt_ratio": 0.8075920049563515}
YEAR_BANDS = {"toa_mean": (0.0777 - 0.5144, 0.0777 + 0.5144),
              "pott_mean": (312.8675 - 0.1210, 312.8675 + 0.1210),
              "rain_over_evap": (1.0201 - 0.0739, 1.0201 + 0.0739),
              "colp_drift": (-2 * 0.4609375, 2 * 0.4609375),
              "peak_wind": (0.75 * 198.4, 1.25 * 198.4),
              "min_dt_ratio": (0.8076 * 0.8, 1.0)}

T0 = time.perf_counter()


def phase(name: str, t_start: float, msg: str = ""):
    print(f"[{name}] {time.perf_counter() - t_start:.2f}s {msg}".rstrip(),
          flush=True)


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


def kernel_name(mangled: str) -> str:
    """A readable name of a kernel of csrc/ from its mangled one: the name
    and its template arguments (the substep's same_base, the RK4 stage,
    the epilogue's levels a lane)."""
    m = re.search(r"\d((?:rk4_)?[a-z_]+_kernel)(.*)", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2).split("Ev", 1)[0])
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def ptxas_lines(log: str):
    """(kernel, lines) for each kernel in nvcc's -Xptxas -v output."""
    kernels, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = (kernel_name(line.split("'")[1]), [])
            kernels.append(cur)
        elif cur and ("registers" in line or "spill" in line
                      or "smem" in line or "stack frame" in line):
            cur[1].append(line.strip())
    return kernels


def timed(fn, n=50, warmup=5) -> float:
    """ms per call of ``fn`` over ``n`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def field_errors(got, want, tol) -> dict:
    """max|got - want| of each field in ``tol``; raises on a non-finite
    field of ``got``."""
    per = {}
    for f in tol:
        a, b = getattr(got, f), getattr(want, f)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {f} from the kernel")
        per[f] = float((a - b).abs().max())
    return per


def over(per: dict, tol: dict) -> list:
    return [f for f, e in per.items() if not e <= tol[f]]


def show(per: dict, tol: dict) -> str:
    bad = over(per, tol)
    return ", ".join(f"{f} {e:.3e}{' (over)' if f in bad else ''}"
                     f" (<= {tol[f]:.1e})" for f, e in per.items())


def bitwise_equal(a, b, fields=("u", "v", "pott", "qv", "qc", "colp")
                  ) -> bool:
    """Every field of ``a`` and ``b`` has the same bits."""
    return all(torch.equal(getattr(a, f).view(torch.int32),
                           getattr(b, f).view(torch.int32)) for f in fields)


def reset_counts():
    """Every counter of the port (``trace.py``) set to 0."""
    trace.reset_counts()


def read_counts() -> collections.Counter:
    """The port's counters, each named as in ``trace.py`` with ``_`` for
    ``.`` (``predictor_masked``, ``corrector_shard``, ``rk4_stage_k1``,
    ``radiation_refreshes``, ``surface_calls``: the names of the kernel
    variants in this script's tables); a name never counted reads 0."""
    return collections.Counter({k.replace(".", "_"): v
                                for k, v in trace.counts().items()})


def moist_state(state, grid, cfg, seed=SEED):
    """``state`` with moisture raised near saturation and the soil bucket
    spread between dry and field capacity, from a numpy generator: relative
    humidity 0.85-1.1 of the Magnus saturation at every level, cloud water
    around the autoconversion threshold. Every term of the epilogue is then
    active (condensation, evaporation of cloud, autoconversion and rain,
    convective mixing where it is on)."""
    r = np.random.default_rng(seed)
    kw = dict(dtype=state.dtype, device=state.device)
    pvb, pvtf, _ = diagnose_pressure(state.colp, grid)
    qs = qsat_water(state.pott * pvtf, 0.5 * (pvb[:-1] + pvb[1:]))
    rh = torch.as_tensor(r.uniform(0.85, 1.1, qs.shape), **kw)
    qc = torch.as_tensor(np.abs(r.normal(0.0, 2e-4, qs.shape)), **kw)
    soil = torch.as_tensor(r.uniform(0.0, cfg.physics.soil_moist_cap,
                                     state.colp.shape), **kw)
    return state.replace(qv=qs * rh, qc=qc, soil_moist=soil)


def rough_state(state, seed=SEED):
    """``state`` with grid-scale noise from a numpy generator: u and v
    +-1 m/s (v's wall row kept at 0), pott +-1 K, qv +-10 %. The horizontal
    diffusion of a smooth 1-degree field moves u, v and pott less in a step
    than fp32 rounding does; on this field it moves each of them far more,
    so a kernel that drops the diffusion of any one field shows."""
    r = np.random.default_rng(seed + 1)
    kw = dict(dtype=state.dtype, device=state.device)
    noise = lambda sd: torch.as_tensor(r.normal(0.0, sd, state.u.shape),
                                       **kw)
    v = state.v + noise(1.0)
    v[:, 0] = 0.0
    return state.replace(u=state.u + noise(1.0), v=v,
                         pott=state.pott + noise(1.0),
                         qv=state.qv * (1.0 + noise(0.1)).clamp(min=0.0))


@dataclasses.dataclass
class CheckInputs:
    cfg: object
    state: object       # 10 plain steps in
    moist: object       # the same with moisture near saturation
    rough: object       # the same with grid-scale noise
    grid: object
    forcing: object
    kw: dict            # with_rad, with_diff of the config
    phys: tuple         # the config's epilogue tuple
    vmask: torch.Tensor  # the single-device wall mask


def check_inputs(dev, cfg=None) -> CheckInputs:
    """``cfg`` (config #3 at full width if None), 10 plain steps from the
    initial state."""
    cfg = baseline_config(3) if cfg is None else cfg
    state, forcing, grid = initialize(cfg, device=dev)
    plain_step = make_step_fn(cfg, dynamics=functools.partial(step_matsuno,
                                                              cfg=cfg))
    for _ in range(10):
        state = plain_step(state, grid, forcing)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    return CheckInputs(cfg=cfg, state=state,
                       moist=moist_state(state, grid, cfg),
                       rough=rough_state(state), grid=grid,
                       forcing=forcing, kw=kw, phys=phys_epilogue_tuple(cfg),
                       vmask=fs.wall_mask(grid.ny, torch.float32, dev))


def epilogue_args(ci: CheckInputs):
    """(ev, base, grid, forcing, dt) of the epilogue checks: the moist state
    and its plain masked prediction."""
    g, f, dt, s = ci.grid, ci.forcing, ci.grid.dt, ci.moist
    pred = fs.fused_substep_plain(s, None, g, f, dt, vmask=ci.vmask, **ci.kw)
    return pred, s, g, f, dt


def epilogue_pair(ci: CheckInputs, phys=None, vmask=None):
    """(kernel, plain) calls of the corrector with the physics epilogue on
    the moist state, evaluated at the plain masked prediction."""
    phys = ci.phys if phys is None else phys
    vmask = ci.vmask if vmask is None else vmask
    args = epilogue_args(ci)
    return (lambda: fs.corrector(*args, phys=phys, vmask=vmask, **ci.kw),
            lambda: fs.fused_substep_plain(*args, phys=phys, vmask=vmask,
                                           **ci.kw))


def phys_with(cfg, **switches) -> tuple:
    """The epilogue tuple of ``cfg`` with some physics switches changed."""
    return phys_epilogue_tuple(cfg.replace(physics=dataclasses.replace(
        cfg.physics, **switches)))


def check_kernels(ci: CheckInputs) -> dict:
    """Phase 3. Returns the errors of every variant; raises after printing
    every reading if any check failed."""
    g, f, dt = ci.grid, ci.forcing, ci.grid.dt
    st, kw = ci.state, ci.kw
    errs, bad = {}, []

    # -- predictor and corrector, v wall by index (the per-step path) --
    pred_plain = fs.fused_substep_plain(st, None, g, f, dt, **kw)
    corr_plain = fs.fused_substep_plain(pred_plain, st, g, f, dt, **kw)

    def launch(kname, **over):
        if kname == "predictor":
            return fs.predictor(st, g, f, dt, **dict(kw, **over))
        return fs.corrector(pred_plain, st, g, f, dt, **dict(kw, **over))

    want = {"predictor": pred_plain, "corrector": corr_plain}
    for kname in ("predictor", "corrector"):
        errs[kname] = field_errors(launch(kname), want[kname], FIELD_TOL)
        print(f"  {kname} max|kernel-plain|: "
              + show(errs[kname], FIELD_TOL), flush=True)
        bad += [f"{kname}: {x} over its bound"
                for x in over(errs[kname], FIELD_TOL)]
    for fault, over_kw in PLANTED_FAULTS.items():
        for kname in ("predictor", "corrector"):
            per = field_errors(launch(kname, **over_kw), want[kname],
                               FIELD_TOL)
            print(f"  planted fault {kname} {fault}, one substep: "
                  + show(per, FIELD_TOL), flush=True)
            if not over(per, FIELD_TOL):
                bad.append(f"{kname} with {fault} stays within every bound")

    # the diffusion of each field, one substep from the rough state: on the
    # smooth state one substep of it moves u, v and pott less than fp32
    # rounding, and more steps grow the rounding as fast as the missing
    # diffusion, so only qv showed a kernel without diffusion
    rough = ci.rough
    rp = fs.fused_substep_plain(rough, None, g, f, dt, **kw)
    rough_want = {"predictor": rp,
                  "corrector": fs.fused_substep_plain(rp, rough, g, f, dt,
                                                      **kw)}
    for kname in ("predictor", "corrector"):
        base = None if kname == "predictor" else rough
        ev = rough if kname == "predictor" else rp
        for fault, over_kw in (("sound", {}),
                               ("with_diff=False", {"with_diff": False})):
            k = dict(kw, **over_kw)
            got = (fs.predictor(ev, g, f, dt, **k) if base is None
                   else fs.corrector(ev, base, g, f, dt, **k))
            per = field_errors(got, rough_want[kname], FIELD_TOL)
            print(f"  rough state, {kname} {fault}, one substep: "
                  + show(per, FIELD_TOL), flush=True)
            if fault == "sound":
                bad += [f"{kname} on the rough state: {x} over its bound"
                        for x in over(per, FIELD_TOL)]
            else:
                bad += [f"{kname} without diffusion keeps {x} within its "
                        "bound on the rough state" for x in DIFFUSED
                        if x not in over(per, FIELD_TOL)]

    # -- the wall as a mask (the packed scan) --
    vm = ci.vmask
    pm = fs.predictor(st, g, f, dt, vmask=vm, **kw)
    if not bitwise_equal(pm, launch("predictor")):
        bad.append("masked predictor differs from the index rule")
    errs["predictor_masked"] = field_errors(
        pm, fs.fused_substep_plain(st, None, g, f, dt, vmask=vm, **kw),
        FIELD_TOL)
    print("  predictor (mask) max|kernel-plain|: "
          + show(errs["predictor_masked"], FIELD_TOL), flush=True)
    bad += [f"masked predictor: {x} over its bound"
            for x in over(errs["predictor_masked"], FIELD_TOL)]
    row = g.ny // 2
    holed = vm.clone()
    holed[row] = 0.0
    ph = fs.predictor(st, g, f, dt, vmask=holed, **kw)
    per = field_errors(ph, fs.fused_substep_plain(st, None, g, f, dt,
                                                  vmask=holed, **kw),
                       FIELD_TOL)
    if bool(ph.v[:, row].abs().max() != 0) or over(per, FIELD_TOL):
        bad.append(f"predictor with v row {row} masked: v there "
                   f"{float(ph.v[:, row].abs().max())}, {per}")

    # -- the corrector with the physics epilogue, on the moist state --
    kern, plain = epilogue_pair(ci)
    want_epi = plain()
    got = kern()
    errs["corrector_epilogue"] = field_errors(got, want_epi, EPI_TOL)
    no_mic = epilogue_pair(ci, phys=phys_with(ci.cfg,
                                              microphysics=False))[1]()
    n_cond = int((want_epi.qv < no_mic.qv).sum())
    rain_inc = float((want_epi.rain - ci.moist.rain).max())
    print(f"  moist state: {n_cond} of {want_epi.qv.numel()} cells condense "
          f"in the plain epilogue; largest rain increment {rain_inc:.3e} "
          "kg/m2", flush=True)
    if n_cond == 0 or not rain_inc > 0:
        bad.append("the moist state does not condense or rain")
    print("  corrector+epilogue (mask) max|kernel-plain|: "
          + show(errs["corrector_epilogue"], EPI_TOL), flush=True)
    bad += [f"epilogue corrector: {x} over its bound"
            for x in over(errs["corrector_epilogue"], EPI_TOL)]
    unmasked = fs.corrector(*epilogue_args(ci), phys=ci.phys, **kw)
    if not bitwise_equal(got, unmasked, tuple(EPI_TOL)):
        bad.append("masked epilogue corrector differs from the index rule")
    kern_h, plain_h = epilogue_pair(ci, vmask=holed)
    got_h, want_h = kern_h(), plain_h()
    per = field_errors(got_h, want_h, EPI_TOL)
    if bool(got_h.v[:, row].abs().max() != 0) or over(per, EPI_TOL):
        bad.append(f"epilogue corrector with v row {row} masked: {per}")
    print(f"  v row {row} masked: predictor and epilogue corrector zero it "
          "and match their plain versions; the single-device mask equals "
          "the index rule bit for bit", flush=True)
    kern_c, plain_c = epilogue_pair(ci, phys=phys_with(ci.cfg,
                                                       convection=True))
    errs["corrector_epilogue_convection"] = field_errors(kern_c(), plain_c(),
                                                         EPI_TOL)
    print("  corrector+epilogue, convection on: "
          + show(errs["corrector_epilogue_convection"], EPI_TOL), flush=True)
    bad += [f"epilogue corrector with convection: {x} over its bound"
            for x in over(errs["corrector_epilogue_convection"], EPI_TOL)]
    for term in EPI_FAULTS:
        kf = epilogue_pair(ci, phys=phys_with(ci.cfg, **{term: False}))[0]
        per = field_errors(kf(), want_epi, EPI_TOL)
        print(f"  planted fault epilogue without {term}, one call (one "
              "shows each term above rounding): " + show(per, EPI_TOL),
              flush=True)
        if not over(per, EPI_TOL):
            bad.append(f"epilogue without {term} stays within every bound")
    if bad:
        raise AssertionError("; ".join(bad))
    return errs


def time_kernels(ci: CheckInputs, card: str) -> dict:
    """Phase 4: each variant and its plain version, in turns (kernel,
    plain, plain, kernel), beside its bound."""
    g, f, dt, st, kw, vm = (ci.grid, ci.forcing, ci.grid.dt, ci.state,
                            ci.kw, ci.vmask)
    pred_plain = fs.fused_substep_plain(st, None, g, f, dt, **kw)
    ev, base = epilogue_args(ci)[:2]
    calls = {
        "predictor": (
            lambda: fs.predictor(st, g, f, dt, **kw),
            lambda: fs.fused_substep_plain(st, None, g, f, dt, **kw),
            (st, None, None, None)),
        "corrector": (
            lambda: fs.corrector(pred_plain, st, g, f, dt, **kw),
            lambda: fs.fused_substep_plain(pred_plain, st, g, f, dt, **kw),
            (pred_plain, st, None, None)),
        "predictor_masked": (
            lambda: fs.predictor(st, g, f, dt, vmask=vm, **kw),
            lambda: fs.fused_substep_plain(st, None, g, f, dt, vmask=vm,
                                           **kw),
            (st, None, None, vm)),
        "corrector_epilogue": (
            *epilogue_pair(ci), (ev, base, ci.phys, vm)),
    }
    timing = {}
    for kname, (kern, plain, (e, b, phys, vmask)) in calls.items():
        timing[kname] = kernel_timing(kname, kern, plain, substep_bound_ms(
            e, b, g, f, kern(), phys=phys, vmask=vmask), card,
            shape=tuple(e.u.shape))
    return timing


def plan_counts(shape) -> dict:
    """The plans' halo counts at a (nz, ny, nx) block: how many times the
    substep copies each needed (field, level) line and scans each column,
    and how many times the epilogue computes each column's surface core
    and height profile (``kernels/fused_substep.py::launch_plan``)."""
    plan = fs.launch_plan(*shape)
    sp = plan.substep
    return {"staged_rows_per_row": round(sp.staged_rows_per_row, 4),
            "scanned_cols_per_col": round(sp.scanned_cols_per_col, 4),
            "profiled_cols_per_col": round(
                plan.epilogue.profiled_cols_per_col, 4)}


def kernel_timing(name, kern, plain, bound, card, n=50, shape=None) -> dict:
    """A kernel and its plain version timed in turns (kernel, plain, plain,
    kernel): device ms per call over ``n`` calls (``device_ms``) and the
    host's enqueue ms beside it, against ``bound`` = (bound ms, what bounds
    it); with ``shape``, the substep plan's counts there beside them."""
    (k1, kh1), (p1, ph1), (p2, ph2), (k2, kh2) = (
        device_ms(kern, n), device_ms(plain, n), device_ms(plain, n),
        device_ms(kern, n))
    (bound_ms, by), ms = bound, 0.5 * (k1 + k2)
    split = launch_ms(kern)
    tm = dict(ms=ms, plain_ms=0.5 * (p1 + p2), bound_ms=bound_ms,
              bound_by=by, enqueue_ms=0.5 * (kh1 + kh2),
              plain_enqueue_ms=0.5 * (ph1 + ph2), launch_ms=split)
    per_launch = ("not measured (the profiler saw no device time)"
                  if split is None else ", ".join(
                      f"{k} {v:.4f}" for k, v in split.items()))
    if shape is not None:
        tm.update(plan_counts(shape))
        per_launch += "; plans: " + ", ".join(
            f"{k} {tm[k]}" for k in plan_counts(shape))
    print(f"  {name}: kernel {ms:.4f} ms on the device ({k1:.4f}, "
          f"{k2:.4f}; per launch, profiled: {per_launch}), "
          f"{tm['enqueue_ms']:.4f} ms host enqueue; plain "
          f"{tm['plain_ms']:.4f} ms ({p1:.4f}, {p2:.4f}), "
          f"{tm['plain_enqueue_ms']:.4f} ms enqueue; bound {bound_ms:.5f} ms "
          f"({by}; {100 * bound_ms / ms:.1f}% of it); no PyTorch library "
          f"call computes it (library_ms null) [{card}]", flush=True)
    return tm


def sanity(s, grid, s0, mean_colp_range=MEAN_COLP, pott_range=POTT_RANGE):
    """The run's sanity checks against its initial state ``s0``; raises on
    the first that fails. The ranges of mean COLP and of POTT are the
    configuration's (the gaussian mountain's by default)."""
    for f in STATE_FIELDS:
        if not bool(torch.isfinite(getattr(s, f)).all()):
            raise AssertionError(f"non-finite {f} after the run")
    max_wind = max(float(s.u.abs().max()), float(s.v.abs().max()))
    area = grid.area.double()[:, None]
    w = area / area.sum() / s.colp.shape[-1]
    mean_colp = float((s.colp.double() * w).sum())
    pott_lo, pott_hi = float(s.pott.min()), float(s.pott.max())
    mass0 = float((s0.colp.double() * area).sum())
    mass1 = float((s.colp.double() * area).sum())
    drift = abs(mass1 - mass0) / mass0
    checks = [(max_wind < MAX_WIND, f"max wind {max_wind:.2f} < {MAX_WIND}"),
              (mean_colp_range[0] < mean_colp < mean_colp_range[1],
               f"mean COLP {mean_colp:.3f} in {mean_colp_range}"),
              (pott_range[0] <= pott_lo and pott_hi <= pott_range[1],
               f"POTT [{pott_lo:.2f}, {pott_hi:.2f}] in {pott_range}"),
              (drift < MASS_DRIFT, f"mass drift {drift:.3e} < {MASS_DRIFT}")]
    for ok, what in checks:
        print(f"  {'ok ' if ok else 'BAD'} {what}", flush=True)
        if not ok:
            raise AssertionError(what)


def main_path(dev, card: str):
    """Phase 5: the run command through the packed scan, counted."""
    args = cli.make_parser().parse_args(MAIN_ARGV)
    run_cfg = cli.build_config(args)
    s0, _, g0 = initialize(run_cfg, device=dev)
    reset_counts()
    res = cli.run(run_cfg, device=args.device)
    counts = read_counts()
    s = res.state
    if res.aborted:
        raise AssertionError("the run aborted on a non-finite state")
    every = run_cfg.physics.rad_every_steps
    want = collections.Counter()
    want.update(predictor_masked=res.steps, corrector_epilogue=res.steps,
                radiation_refreshes=sum(1 for k in range(res.steps)
                                        if k % every == 0))
    if counts != want:
        raise AssertionError(f"counts {counts} for {res.steps} steps, "
                             f"expected {want}: one masked predictor and "
                             "one epilogue corrector a step, radiation every "
                             f"{every} steps, nothing else")
    if len(res.chunks) < 3:
        raise AssertionError(f"chunks {res.chunks}: expected three")
    dt0 = res.dts[0]
    if dt0 != g0.dt:
        raise AssertionError(f"first dt {dt0} != the grid's {g0.dt}")
    for rec, dt_next in zip(res.records[:-1], res.dts[1:]):
        want_dt = round_to(max(adaptive_cfl_dt(res.min_dx,
                                               run_cfg.numerics.cfl,
                                               rec["max_wind"]), 0.05 * dt0),
                           torch.float32)
        if dt_next != want_dt:
            raise AssertionError(f"dt {dt_next} != adaptive_cfl_dt {want_dt}")
    horizon = run_cfg.sim_days * 86400.0
    if abs(float(s.t) - horizon) > 0.5 * res.dts[-1]:
        raise AssertionError(f"t = {float(s.t)} s misses the horizon "
                             f"{horizon} s")
    sanity(s, res.grid, s0)
    points = run_cfg.grid.nx * run_cfg.grid.ny * run_cfg.grid.nz
    steady_steps = sum(res.chunks[1:])
    steady_wall = sum(r["wall_s"] for r in res.records[1:])
    steady_ms = 1e3 * steady_wall / steady_steps
    print(f"  {res.steps} steps {res.chunks} in {res.wall_s:.3f}s: "
          f"{1e3 * res.wall_s / res.steps:.3f} ms/step "
          f"({points * res.steps / res.wall_s / 1e6:.2f} M grid-points/s); "
          f"after the first chunk {steady_ms:.3f} ms/step "
          f"({points * steady_steps / steady_wall / 1e6:.2f} "
          f"M grid-points/s); dt {res.dts}; counts {counts} [{card}]",
          flush=True)
    return run_cfg, res, counts, steady_ms


def per_step_path(run_cfg, n, dev, card: str):
    """Phase 6: the per-step path for ``n`` steps from the initial state,
    counted and checked; the packed scan over the same steps compared with
    it; both timed in turns."""
    s0, forcing, grid = initialize(run_cfg, device=dev)
    step = make_step_fn(run_cfg)
    packed = make_chunk_runner(run_cfg, n)

    def per_step():
        return run_scan(step, s0, grid, forcing, n)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / n

    reset_counts()
    a, ms_a1 = wall(per_step)
    counts = read_counts()
    every = run_cfg.physics.rad_every_steps
    want = collections.Counter()
    want.update(predictor=n, corrector=n, surface_calls=n,
                turbulence_calls=n, microphysics_calls=n,
                radiation_refreshes=sum(1 for k in range(n)
                                        if k % every == 0))
    if counts != want:
        raise AssertionError(f"per-step path counts {counts} for {n} steps, "
                             f"expected {want}")
    sanity(a, grid, s0)
    b, ms_b1 = wall(lambda: packed(s0, grid, forcing))
    b2, ms_b2 = wall(lambda: packed(s0, grid, forcing))
    _, ms_a2 = wall(per_step)
    if not bitwise_equal(b, b2, STATE_FIELDS):
        raise AssertionError("two packed-scan runs from one state differ")
    per = field_errors(b, a, PATHS_TOL)
    print(f"  {n} steps, packed scan vs per-step path: "
          + show(per, PATHS_TOL), flush=True)
    if over(per, PATHS_TOL):
        raise AssertionError(f"the two paths differ beyond their bounds: "
                             f"{per}")
    ms_a, ms_b = 0.5 * (ms_a1 + ms_a2), 0.5 * (ms_b1 + ms_b2)
    print(f"  ms/step over {n} steps from the initial state (radiation "
          f"refresh included): per-step path {ms_a:.3f} ({ms_a1:.3f}, "
          f"{ms_a2:.3f}), packed scan {ms_b:.3f} ({ms_b1:.3f}, {ms_b2:.3f}); "
          f"per-step counts {counts} [{card}]", flush=True)
    return counts, per, ms_a, ms_b


def breakdown(cfg, state, grid, forcing, step_ms, card):
    """Each layer of a model step timed alone on the final state of the main
    path: ms per call over back-to-back calls (CUDA events; the device's time
    where it exceeds the host's) and the host's enqueue ms per call. Their
    sums for each path, weighted by calls per step, are set beside the
    measured ms/step of the main path."""
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    dt = grid.dt
    vm = fs.wall_mask(grid.ny, torch.float32, state.device)
    phys = phys_epilogue_tuple(cfg)
    pred = fs.predictor(state, grid, forcing, dt, **kw)
    press = diagnose_pressure(state.colp, grid)
    every = cfg.physics.rad_every_steps
    # (name, fn, calls a step on the packed scan, on the per-step path)
    layers = [
        (f"radiation refresh (1 step in {every})",
         lambda: radiation.compute_radiation(state, grid, forcing, cfg),
         1.0 / every, 1.0 / every),
        ("predictor kernel (mask)", lambda: fs.predictor(
            state, grid, forcing, dt, vmask=vm, **kw), 1.0, 0.0),
        ("corrector kernel with physics epilogue (mask)",
         lambda: fs.corrector(pred, state, grid, forcing, dt, phys=phys,
                              vmask=vm, **kw), 1.0, 0.0),
        ("predictor kernel", lambda: fs.predictor(state, grid, forcing, dt,
                                                  **kw), 0.0, 1.0),
        ("corrector kernel", lambda: fs.corrector(pred, state, grid, forcing,
                                                  dt, **kw), 0.0, 1.0),
        ("pressure diagnostics", lambda: diagnose_pressure(state.colp, grid),
         0.0, 1.0),
        ("surface split", lambda: surface.surface_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("turbulence split", lambda: turbulence.turbulence_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("microphysics split", lambda: microphysics.microphysics_step(
            state, grid, forcing, cfg, dt, press=press), 0.0, 1.0),
        ("chunk diagnostics (1 per chunk)",
         lambda: diagnostics(state, grid, forcing, cfg), 1.0 / 105,
         1.0 / 105),
    ]
    sums, host_sums = [0.0, 0.0], [0.0, 0.0]
    for name, fn, packed_share, step_share in layers:
        dev_ms = timed(fn, n=20, warmup=3)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = 1e3 * (time.perf_counter() - h0) / 20
        torch.cuda.synchronize()
        sums[0] += packed_share * dev_ms
        sums[1] += step_share * dev_ms
        host_sums[0] += packed_share * host_ms
        host_sums[1] += step_share * host_ms
        print(f"  {name}: back-to-back {dev_ms:.4f} ms, host enqueue "
              f"{host_ms:.4f} ms per call", flush=True)
    print(f"  layers summed per step: packed scan {sums[0]:.3f} ms (against "
          f"{step_ms:.3f} ms/step of the main path), per-step path "
          f"{sums[1]:.3f} ms [{card}]", flush=True)
    print(f"  one packed-scan step, host against device: {host_sums[0]:.3f} "
          f"ms of host enqueue, {sums[0]:.3f} ms of device time (layers "
          f"summed as above; the larger bounds the step) [{card}]",
          flush=True)


def windy_state(state):
    """``state`` with strong winds near the surface and vertical shear: u
    raised by up to 40 m/s and v lowered by up to 30 m/s over the lowest
    four levels (full at the bottom, v's wall row kept at 0). On the moist
    check state the bottom winds are a few m/s, and neither the surface
    drag nor the K-diffusion of u and v moves them by more than fp32
    rounding in one call; here each moves them by far more."""
    nz = state.u.shape[0]
    k = torch.arange(nz, dtype=state.dtype, device=state.device)
    ramp = ((k - (nz - 5)) / 4.0).clamp(0.0, 1.0)[:, None, None]
    v = state.v - 30.0 * ramp
    v[:, 0] = 0.0
    return state.replace(u=state.u + 40.0 * ramp, v=v)


def check_momentum(ci: CheckInputs, bad: list):
    """The epilogue corrector on the windy state: sound within EPI_TOL,
    and without the surface or the turbulence u and v each over it."""
    g, f, dt = ci.grid, ci.forcing, ci.grid.dt
    windy = windy_state(ci.moist)
    pred = fs.fused_substep_plain(windy, None, g, f, dt, vmask=ci.vmask,
                                  **ci.kw)

    def call(kernel, phys):
        fn = fs.corrector if kernel else fs.fused_substep_plain
        return fn(pred, windy, g, f, dt, phys=phys, vmask=ci.vmask, **ci.kw)

    want = call(False, ci.phys)
    per = field_errors(call(True, ci.phys), want, EPI_TOL)
    print("  windy state, corrector+epilogue max|kernel-plain|: "
          + show(per, EPI_TOL), flush=True)
    bad += [f"epilogue corrector on the windy state: {x} over its bound"
            for x in over(per, EPI_TOL)]
    for term in MOMENTUM_FAULTS:
        per = field_errors(call(True, phys_with(ci.cfg, **{term: False})),
                           want, EPI_TOL)
        print(f"  planted fault epilogue without {term}, windy state: u "
              f"{per['u']:.3e}, v {per['v']:.3e} (bounds "
              f"{EPI_TOL['u']:.1e}, {EPI_TOL['v']:.1e})", flush=True)
        bad += [f"epilogue without {term} keeps {x} within its bound on "
                "the windy state" for x in ("u", "v")
                if x not in over(per, EPI_TOL)]


def check_tall(dev, bad: list):
    """The epilogue corrector on a column of TALL_NZ levels (three levels a
    lane of its warp) against its plain version, on the moist state."""
    b3 = baseline_config(3)
    cfg = resolve_rad_interval(b3.replace(grid=dataclasses.replace(
        b3.grid, nx=TALL_GRID[0], ny=TALL_GRID[1], nz=TALL_NZ)))
    state, forcing, grid = initialize(cfg, device=dev)
    moist = moist_state(state, grid, cfg)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    vm = fs.wall_mask(grid.ny, torch.float32, dev)
    pred = fs.fused_substep_plain(moist, None, grid, forcing, grid.dt,
                                  vmask=vm, **kw)
    args = (pred, moist, grid, forcing, grid.dt)
    phys = phys_epilogue_tuple(cfg)
    per = field_errors(fs.corrector(*args, phys=phys, vmask=vm, **kw),
                       fs.fused_substep_plain(*args, phys=phys, vmask=vm,
                                              **kw), TALL_TOL)
    print(f"  {TALL_NZ} levels on {TALL_GRID[0]}x{TALL_GRID[1]}, "
          "corrector+epilogue max|kernel-plain|: "
          + show(per, TALL_TOL), flush=True)
    bad += [f"{TALL_NZ}-level epilogue: {x} over its bound"
            for x in over(per, TALL_TOL)]


@dataclasses.dataclass
class Block:
    """A shard's block cut from the #4 check state, with its statics."""

    name: str
    lay: object
    state: object
    grid: object
    forcing: object
    vmask: torch.Tensor
    strips: list


def noisy_state(baseline: int, dev):
    """Config ``baseline`` at full width, 10 plain steps from the initial
    state, its moisture raised near saturation, grid-scale noise added, and
    colp +-20 Pa. Returns (cfg, state, forcing, grid)."""
    cfg = baseline_config(baseline)
    state, forcing, grid = initialize(cfg, device=dev)
    plain_step = make_step_fn(cfg, dynamics=functools.partial(step_matsuno,
                                                              cfg=cfg))
    for _ in range(10):
        state = plain_step(state, grid, forcing)
    state = rough_state(moist_state(state, grid, cfg))
    r = np.random.default_rng(SEED + 2)
    colp = state.colp + torch.as_tensor(r.normal(0.0, 20.0,
                                                 state.colp.shape),
                                        dtype=state.dtype, device=dev)
    return cfg, state.replace(colp=colp), forcing, grid


def shard_blocks(cfg, state, forcing, grid, dev, which=CHECK_BLOCKS):
    """The blocks ``which`` ((name, mesh, shard), CHECK_BLOCKS) cut from
    ``state``. Returns (blocks, kw, phys)."""
    blocks = []
    for name, (n_lat, n_lon), shard in which:
        lay = sharding.layout(Mesh(n_lat, n_lon, dev), shard, grid.ny,
                              grid.nx)
        g = sharding.split_grid(grid, lay)
        f = sharding.split_forcing(forcing, lay)
        vm = row_mask(lay, torch.float32, dev)
        strips = [SeamStrip(side, lay, g, f, vm, sharding.Halo())
                  for side, has in (("south", lay.gs), ("north", lay.gn))
                  if has]
        blocks.append(Block(name, lay, sharding.split_state(state, lay), g,
                            f, vm, strips))
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    return blocks, kw, phys_epilogue_tuple(cfg)


def kept_rows(b: Block, st) -> slice:
    """The rows of strip ``st`` that replace the main launch's and lie in
    the block's interior, in strip coordinates."""
    d0, _, n = st.keep
    lo, hi = max(d0, b.lay.rows.start), min(d0 + n, b.lay.rows.stop)
    return slice(lo - st.r0, hi - st.r0)


def region_errors(got, want, rows, cols, tol) -> dict:
    """field_errors over rows x cols of each field."""
    per = {}
    for f in tol:
        a = getattr(got, f)[..., rows, cols]
        b = getattr(want, f)[..., rows, cols]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"non-finite {f} from the kernel")
        per[f] = float((a - b).abs().max())
    return per


def shard_calls(b: Block, kw, phys, dt):
    """(variant, kernel call, plain call, rows, tol, (ev, base, phys,
    vmask, grid, forcing)) of every shard-local and seam-strip program on
    block ``b``."""
    skw = dict(kw, vmask=b.vmask)
    s, g, f = b.state, b.grid, b.forcing
    pred = fs.fused_substep_plain(s, None, g, f, dt, **skw)
    calls = [
        ("predictor_shard",
         lambda: fs.predictor(s, g, f, dt, part="shard", **skw),
         lambda: fs.fused_substep_plain(s, None, g, f, dt, **skw),
         b.lay.rows, SHARD_TOL, (s, None, None, b.vmask, g, f)),
        ("corrector_shard",
         lambda: fs.corrector(pred, s, g, f, dt, phys=phys, part="shard",
                              **skw),
         lambda: fs.fused_substep_plain(pred, s, g, f, dt, phys=phys, **skw),
         b.lay.rows, SHARD_EPI_TOL, (pred, s, phys, b.vmask, g, f))]
    for st in b.strips:
        ss, ps = st.cut(s), st.cut(pred)
        tkw = dict(skw, vmask=st.vmask)
        sg, sf = st.grid, st.forcing
        calls += [
            (f"predictor_{st.part}",
             functools.partial(fs.predictor, ss, sg, sf, dt, part=st.part,
                               **tkw),
             functools.partial(fs.fused_substep_plain, ss, None, sg, sf, dt,
                               **tkw),
             kept_rows(b, st), SHARD_TOL, (ss, None, None, st.vmask, sg, sf)),
            (f"corrector_{st.part}",
             functools.partial(fs.corrector, ps, ss, sg, sf, dt, phys=phys,
                               part=st.part, **tkw),
             functools.partial(fs.fused_substep_plain, ps, ss, sg, sf, dt,
                               phys=phys, **tkw),
             kept_rows(b, st), SHARD_EPI_TOL, (ps, ss, phys, st.vmask, sg, sf))]
    return calls


def check_shards(noisy, dev, bad: list, which=CHECK_BLOCKS):
    """Each shard-local and seam-strip variant against its plain version on
    the blocks ``which`` cut from the noisy state ``noisy`` (CHECK_BLOCKS of
    the #4 state). Returns (errors by variant, the blocks and what the
    timing needs)."""
    blocks, kw, phys = shard_blocks(*noisy, dev, which)
    dt = blocks[0].grid.dt
    errs = {}
    for b in blocks:
        lay = b.lay
        print(f"  {b.name} block: shard ({lay.lat_idx}, {lay.lon_idx}), "
              f"{tuple(b.state.u.shape)} with ghosts s/n/cols "
              f"{lay.gs}/{lay.gn}/{lay.gx}", flush=True)
        for name, kern, plain, rows, tol, _ in shard_calls(b, kw, phys, dt):
            per = region_errors(kern(), plain(), rows, lay.cols, tol)
            errs[name] = {f: max(e, errs.get(name, {}).get(f, 0.0))
                          for f, e in per.items()}
            print(f"    {name} max|kernel-plain| (interior): "
                  + show(per, tol), flush=True)
            bad += [f"{name} on the {b.name} block: {x} over its bound"
                    for x in over(per, tol)]
    return errs, (blocks, kw, phys, dt)


# the variants that time_shards times on each block of CHECK_BLOCKS: #4's
# 2x4 shapes (the lon-seam block and its south strip, the polar-edge
# block's north strip)
SHARD_TIMING = (("lon-seam", ("predictor_shard", "corrector_shard",
                              "predictor_south_strip",
                              "corrector_south_strip")),
                ("polar-edge", ("predictor_north_strip",
                                "corrector_north_strip")))


def time_shards(shard_inputs, card: str, plan=SHARD_TIMING) -> dict:
    """Each shard-local and seam-strip variant of ``plan`` ((block, variant
    names)) and its plain version, in turns, beside its bound."""
    blocks, kw, phys, dt = shard_inputs
    by_name = {b.name: b for b in blocks}
    timing = {}
    for bname, names in plan:
        b = by_name[bname]
        for name, kern, plain, _, _, (ev, base, ph, vm, g, f) in shard_calls(
                b, kw, phys, dt):
            if name not in names:
                continue
            timing[name] = kernel_timing(
                f"{name} at {tuple(ev.u.shape)}", kern, plain,
                substep_bound_ms(ev, base, g, f, kern(), phys=ph, vmask=vm),
                card, shape=tuple(ev.u.shape))
    return timing


# The substep against another checkout's substep kernel (the parent
# commit's, unpacked into a git-ignored directory), bit for bit, on the
# same inputs, and timed in turns (``check_against``; ``tools/
# kernel_bitwise.py``): (name, (nz, ny, nx)) of every block the port
# launches it on (#3 and #5, the shard blocks and seam strips of #4's 2x4,
# 2x2, 1x4 and 4x1 meshes and of #5's 4x8 and 2x2, the gates' shapes) and
# of 2 to 128 levels.
AGAINST_CASES = (
    ("#3", (32, 180, 360)), ("#5", (32, 720, 1440)),
    ("#4 2x4 shard block", (32, 183, 186)),
    ("#4 2x4 seam strip", (32, 9, 186)),
    ("#5 4x8 middle shard block", (32, 186, 186)),
    ("#4 2x2 shard block", (32, 183, 366)),
    ("#4 2x2 seam strip", (32, 9, 366)),
    ("#5 2x2 shard block", (32, 363, 726)),
    ("#5 2x2 seam strip", (32, 9, 726)),
    ("#4 1x4 shard block", (32, 360, 186)),
    ("#4 4x1 shard block", (32, 96, 720)),
    ("#4 4x1 seam strip", (32, 9, 720)),
    ("closure gate", (8, 48, 96)), ("equilibrium gate", (10, 30, 60)),
    ("fine-grid gate", (16, 90, 180)),
    *((f"{nz} levels", (nz, 32, 64)) for nz in (2, 8, 32, 64, 96, 128)),
    ("128 levels at #3's grid", (128, 180, 360)))


def reference_kernels(root: str):
    """The ``kernels/fused_substep.py`` of the checkout at ``root`` as a
    module of its own: its wrappers launch its own kernels, built from its
    own ``csrc/`` into its own build directory, with its own plan; every
    other module is this checkout's."""
    import importlib.util
    path = os.path.join(os.path.abspath(root), "climate_model_tpu_torch",
                        "kernels", "fused_substep.py")
    spec = importlib.util.spec_from_file_location(
        "climate_model_tpu_torch.kernels._reference_substep", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def against_inputs(shape, dev):
    """Config #3's physics on a (nz, ny, nx) grid from its initial state,
    moisture near saturation, grid-scale noise, colp +-20 Pa and a
    radiative heating of +-1e-4 K/s: (state, forcing, grid, kw), kw with
    the substep's switches and ``phys``, the epilogue's tuple."""
    nz, ny, nx = shape
    b3 = baseline_config(3)
    cfg = resolve_rad_interval(b3.replace(grid=dataclasses.replace(
        b3.grid, nx=nx, ny=ny, nz=nz)))
    state, forcing, grid = initialize(cfg, device=dev)
    state = rough_state(moist_state(state, grid, cfg))
    r = np.random.default_rng(SEED + 3)
    kw = dict(dtype=state.dtype, device=dev)
    state = state.replace(
        colp=state.colp + torch.as_tensor(r.normal(0.0, 20.0, (ny, nx)),
                                          **kw),
        dpottdt_rad=torch.as_tensor(r.normal(0.0, 1e-4, (nz, ny, nx)),
                                    **kw))
    num = cfg.numerics
    return state, forcing, grid, dict(
        with_rad=cfg.physics.radiation,
        with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist),
        phys=phys_epilogue_tuple(cfg))


def against_calls(mod, state, forcing, grid, kw):
    """(variant, call) of ``mod``'s kernel launches on one input: the
    predictor and the corrector, v wall by index and by mask, and the
    corrector without the radiative source and the diffusion; the
    corrector with the physics epilogue (``phys``), v wall by index and by
    mask; and the epilogue alone on the plain corrector's post-dynamics
    state."""
    g, f, dt = grid, forcing, grid.dt
    kw = dict(kw)
    phys = kw.pop("phys")
    vm = fs.wall_mask(grid.ny, torch.float32, state.u.device)
    pred = fs.fused_substep_plain(state, None, g, f, dt, **kw)
    post = fs.fused_substep_plain(pred, state, g, f, dt, vmask=vm, **kw)
    return (
        ("predictor", lambda: mod.predictor(state, g, f, dt, **kw)),
        ("predictor_masked",
         lambda: mod.predictor(state, g, f, dt, vmask=vm, **kw)),
        ("corrector", lambda: mod.corrector(pred, state, g, f, dt, **kw)),
        ("corrector_masked",
         lambda: mod.corrector(pred, state, g, f, dt, vmask=vm, **kw)),
        ("corrector_bare",
         lambda: mod.corrector(pred, state, g, f, dt, vmask=vm,
                               with_rad=False, with_diff=False)),
        ("corrector_phys",
         lambda: mod.corrector(pred, state, g, f, dt, phys=phys, **kw)),
        ("corrector_phys_masked",
         lambda: mod.corrector(pred, state, g, f, dt, phys=phys, vmask=vm,
                               **kw)),
        ("epilogue",
         lambda: mod.epilogue(post, g, f, dt, phys=phys, vmask=vm)))


# The fields ``check_against`` compares: every field a launch writes.
AGAINST_FIELDS = ("u", "v", "pott", "qv", "qc", "colp", "tsurf", "rain",
                  "soil_moist")
# The launches ``check_against`` times in turns: (variant, launch).
AGAINST_TIMED = (("predictor_masked", "substep"),
                 ("corrector_masked", "substep"),
                 ("corrector_phys_masked", "epilogue"))


def profiled_ms(fn, tries=3) -> dict:
    """``launch_ms(fn)``, profiled again where the profiler recorded no
    device time (it misses a whole profile now and then)."""
    for _ in range(tries):
        split = launch_ms(fn)
        if split is not None:
            return split
    raise RuntimeError(f"the profiler recorded no device time in {tries} "
                       "profiles")


def check_against(ref, dev, card: str, cases=AGAINST_CASES, timed=True
                  ) -> dict:
    """Every variant of ``against_calls`` at every case, this checkout's
    kernels against ``ref``'s (``reference_kernels``): equal bit for bit in
    every field they write; with ``timed``, the device ms of each launch of
    ``AGAINST_TIMED`` (``launch_ms``: the masked predictor's and
    corrector's substep, the epilogue of the masked corrector with
    ``phys``) in turns (reference, this, this, reference) beside the plans'
    counts. Raises after printing every case if any differs."""
    bad, out = [], {}
    for name, shape in cases:
        state, forcing, grid, kw = against_inputs(shape, dev)
        mine = dict(against_calls(fs, state, forcing, grid, kw))
        theirs = dict(against_calls(ref, state, forcing, grid, kw))
        same = {v: bitwise_equal(mine[v](), theirs[v](), AGAINST_FIELDS)
                for v in mine}
        bad += [f"{name} {shape}: {v} differs from the reference kernel"
                for v, ok in same.items() if not ok]
        line = (f"  {name} {shape}: bit for bit "
                + ", ".join(f"{v} {'yes' if ok else 'NO'}"
                            for v, ok in same.items()))
        row = {"same": same, **plan_counts(shape)}
        if timed:
            for v, launch in AGAINST_TIMED:
                t = [profiled_ms(fn)[launch] for fn in
                     (theirs[v], mine[v], mine[v], theirs[v])]
                key = f"{v}.{launch}"
                row[key] = {"reference_ms": 0.5 * (t[0] + t[3]),
                            "ms": 0.5 * (t[1] + t[2]), "turns": t}
                line += (f"; {key} {row[key]['ms']:.4f} ms a launch against "
                         f"{row[key]['reference_ms']:.4f} ("
                         + " / ".join(f"{x:.4f}" for x in t) + ")")
        print(line + "; plan " + ", ".join(
            f"{k} {row[k]}" for k in plan_counts(shape)) + f" [{card}]",
            flush=True)
        out[name] = row
        del state, forcing, grid, mine, theirs
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def run_argv(argv, dev):
    """``cli.run`` of ``argv``, with every counter set to 0 just before and
    read just after. Returns (cfg, result, counts, steady ms/step)."""
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    reset_counts()
    res = cli.run(cfg, device=dev)
    counts = read_counts()
    if res.aborted:
        raise AssertionError(f"{argv}: the run aborted on a non-finite state")
    steady = 1e3 * sum(r["wall_s"] for r in res.records[1:]) \
        / max(sum(res.chunks[1:]), 1)
    return cfg, res, counts, steady


def state_diffs(a, b) -> dict:
    """max|a - b| of every state field; inf where a is not finite."""
    return {f: (float((getattr(a, f) - getattr(b, f)).abs().max())
                if bool(torch.isfinite(getattr(a, f)).all())
                else float("inf")) for f in STATE_FIELDS}


class _LeaveOut:
    """An exchange with part of its work left out (a planted fault)."""

    def __init__(self, inner, what: str):
        self.inner, self.what = inner, what
        self.calls = {"lon": 0, "lat": 0}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _left_out(self, kind: str) -> bool:
        # the overlap schedule exchanges each kind twice a step: the
        # time-n fields, then the predicted ones
        self.calls[kind] += 1
        return self.what == f"{kind} exchange" or (
            self.what == f"{kind} exchange after the predictor"
            and self.calls[kind] % 2 == 0)

    def refresh_cols(self, fields):
        if not self._left_out("lon"):
            self.inner.refresh_cols(fields)

    def start_lat(self, fields):
        if self._left_out("lat"):
            return _NoWait()
        return self.inner.start_lat(fields)


class _NoWait:
    def wait(self):
        pass


def sharded_blocks(cfg, noisy, n, dev, halo=sharding.Halo(),
                   leave_out=None):
    """``n`` steps of the sharded runner of ``cfg`` from the ``noisy_state``
    ``noisy``, optionally with a planted fault; the final blocks."""
    _, s0, f0, g0 = noisy
    ss = sharding.shard(make_mesh(cfg, device=dev), s0, g0, f0, halo)
    if leave_out:
        ss = ss.replace(exchange=_LeaveOut(ss.exchange, leave_out))
    return make_chunk_runner(cfg, n)(ss, g0, f0)


def sharded_steps(cfg, noisy, n, dev, halo=sharding.Halo(),
                  leave_out=None):
    """``sharded_blocks``, gathered into the global final state."""
    return sharding.gather(sharded_blocks(cfg, noisy, n, dev, halo,
                                          leave_out))


class peak_memory(contextlib.AbstractContextManager):
    """The device memory that a block allocates at its peak, above what was
    allocated when it began (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``); read as ``.bytes`` after the block."""

    def __init__(self, dev):
        self.dev, self.bytes = dev, 0

    def __enter__(self):
        torch.cuda.reset_peak_memory_stats(self.dev)
        self.base = torch.cuda.memory_allocated(self.dev)
        return self

    def __exit__(self, *exc):
        self.bytes = torch.cuda.max_memory_allocated(self.dev) - self.base

    def __str__(self):
        return (f"peak device memory {self.bytes / 1e9:.3f} GB above the "
                f"{self.base / 1e9:.3f} GB held before")


def halo_copies(cfg, ranks: bool) -> tuple:
    """The batched slab copies (``kernels/halo_copy.py``) of one step of
    ``cfg``'s packed scan on its mesh, summed over its shards: (launches,
    slabs). A step refreshes the 12 prognostic and radiative fields, then
    the 6 predicted ones; under halo overlap each seam strip cuts the 6 3-D
    fields of a State three times (the 2-D ones are views) and splices the
    predictor's 6 fields and the corrector's 6 or, with the epilogue, 9.
    In one process (``LocalExchange``) a column refresh of F fields is one
    batch of shards x 2 x F slabs and a row exchange one of F slabs a lat
    neighbour of every shard; across ranks (``ranks``, ``DistExchange``)
    each rank packs and unpacks 2F slabs of a column refresh and F a lat
    neighbour of a row exchange. A launch takes at most ``MAX_SLABS``."""
    sh = cfg.sharding
    n_lat, n_lon = sh.mesh_lat, sh.mesh_lon
    lat_nbrs = [(a > 0) + (a < n_lat - 1) for a in range(n_lat)
                for _ in range(n_lon)]
    batches = []
    for f in (12, 6):
        if n_lon > 1:
            batches += [2 * f] * 2 * len(lat_nbrs) if ranks \
                else [len(lat_nbrs) * 2 * f]
        if n_lat > 1:
            batches += [k * f for k in lat_nbrs for _ in (0, 1)] if ranks \
                else [sum(lat_nbrs) * f]
    if sh.halo_overlap and n_lat > 1:
        cut = 6 if cfg.grid.nz > 1 else 0
        corr = 9 if phys_epilogue_tuple(cfg) is not None else 6
        batches += [cut, 6, cut, cut, corr] * sum(lat_nbrs)
    return (sum(-(-k // hc.MAX_SLABS) for k in batches), sum(batches))


def want_counts(cfg, n: int, keys, start: int = 0,
                ranks: bool = False) -> dict:
    """The launch and call counts of ``n`` steps of ``cfg`` from step
    ``start`` on the packed scan, over every shard of its mesh (0 for each
    other key of ``keys``): unsharded one masked predictor and one epilogue
    corrector a step; on a mesh a shard launch of each program a step for
    each shard and, under halo overlap, a south-strip and a north-strip
    launch for each lat seam, and the batched slab copies of
    ``halo_copies`` (``ranks``: a shard a rank); a radiation refresh on
    each block every ``rad_every_steps`` steps."""
    sh = cfg.sharding
    shards = sh.mesh_lat * sh.mesh_lon
    every = cfg.physics.rad_every_steps
    refreshes = sum(1 for k in range(start, start + n) if k % every == 0)
    want = collections.Counter(dict.fromkeys(keys, 0))
    if shards == 1:
        want.update(predictor_masked=n, corrector_epilogue=n,
                    radiation_refreshes=refreshes)
        return want
    launches, slabs = halo_copies(cfg, ranks)
    want.update(predictor_shard=shards * n, corrector_shard=shards * n,
                radiation_refreshes=shards * refreshes,
                halo_copy_launches=n * launches, halo_copy_slabs=n * slabs)
    if sh.halo_overlap and sh.mesh_lat > 1:
        seams = sh.mesh_lon * (sh.mesh_lat - 1)
        for part in ("south_strip", "north_strip"):
            want[f"predictor_{part}"] = seams * n
            want[f"corrector_{part}"] = seams * n
    return want


def mesh_runs(argvs, dev, card: str, bad: list) -> dict:
    """Each ``(name, argv)`` of ``argvs`` (names ``overlap``, ``blocking``,
    ``unsharded``) through ``run_argv``, counted: one masked predictor and
    one epilogue corrector a step unsharded; on the mesh a shard launch of
    each program a step for each shard and, with overlap, a south-strip and
    a north-strip launch for each lat seam. Returns {name: (cfg, result,
    counts, steady ms/step, peak_memory)}."""
    runs = {}
    for name, argv in argvs:
        with peak_memory(dev) as peak:
            cfg, res, counts, steady = run_argv(argv, dev)
        runs[name] = (cfg, res, counts, steady, peak)
        n = res.steps
        want = want_counts(cfg, n, counts)
        print(f"  {name}: {res.path}; {n} steps {res.chunks}, "
              f"{1e3 * res.wall_s / n:.3f} ms/step, after the first chunk "
              f"{steady:.3f} ms/step; {peak}; counts {counts} [{card}]",
              flush=True)
        if counts != want:
            bad.append(f"{name}: counts {counts}, expected {want}")
    return runs


def mesh_compare(runs: dict, bad: list):
    """The mesh runs against the unsharded one and each other: dts, every
    field within SHARDED_TOL, and whether bit for bit."""
    base = runs["unsharded"][1]
    for name in ("overlap", "blocking"):
        if runs[name][1].dts != base.dts:
            bad.append(f"{name}: dts {runs[name][1].dts} != {base.dts}")
    pairs = (("overlap", "unsharded"), ("blocking", "unsharded"),
             ("overlap", "blocking"))
    for a, b in pairs:
        sa, sb = runs[a][1].state, runs[b][1].state
        per = state_diffs(sa, sb)
        same = bitwise_equal(sa, sb, STATE_FIELDS)
        print(f"  {a} vs {b}: bitwise equal {same}; "
              + show({f: per[f] for f in SHARDED_TOL}, SHARDED_TOL),
              flush=True)
        bad += [f"{a} vs {b}: {x} over its bound"
                for x in over({f: per[f] for f in SHARDED_TOL}, SHARDED_TOL)]


def mesh_faults(runs: dict, noisy, faults, dev, bad: list):
    """FAULT_STEPS steps of the overlap run's config from the noisy state,
    sound and with each planted fault of ``faults`` ((name, sharded_steps
    keywords)), against the unsharded grid: the sound run within
    SHARDED_TOL, each fault over it (but the lon exchange left out after
    the predictor only, a reading)."""
    cfg, cfg1 = runs["overlap"][0], runs["unsharded"][0]
    _, s0, f0, g0 = noisy
    label = f"noisy {cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz} state"
    want = make_chunk_runner(cfg1, FAULT_STEPS)(s0, g0, f0)
    for fault, kw in (("none (sound)", {}), *faults):
        got = sharded_steps(cfg, noisy, FAULT_STEPS, dev, **kw)
        per = state_diffs(got, want)
        per = {f: per[f] for f in SHARDED_TOL}
        same = bitwise_equal(got, want, STATE_FIELDS)
        print(f"  {label}, {FAULT_STEPS} steps, overlap run, planted "
              f"fault: {fault}; vs unsharded, bitwise equal {same}: "
              + show(per, SHARDED_TOL), flush=True)
        if fault == "none (sound)":
            bad += [f"sound sharded run from the {label}: {x} over its "
                    "bound" for x in over(per, SHARDED_TOL)]
        elif "after the predictor only" in fault:
            pass        # a reading, not a gate (PERF.md, Findings)
        elif not over(per, SHARDED_TOL):
            bad.append(f"the {fault} stays within every bound")


LAT_FAULT = ("strips on stale lat rows (lat exchange left out)",
             dict(leave_out="lat exchange"))


def sharded_path(noisy, dev, card: str):
    """Phase 8: BASELINE #4 on its 2x4 mesh in one process through the run
    command, with halo overlap (counted), then the blocking schedule and
    the unsharded grid from the same initial state; each pair compared.
    Then FAULT_STEPS steps from the noisy #4 state: the sound sharded run
    and each planted fault against the unsharded grid."""
    bad = []
    runs = mesh_runs((("overlap", SHARDED_ARGV), ("blocking", BLOCKING_ARGV),
                      ("unsharded", UNSHARDED_ARGV)), dev, card, bad)
    s0, _, g0 = initialize(runs["overlap"][0], device=dev)
    sanity(runs["overlap"][1].state, runs["overlap"][1].grid, s0)
    mesh_compare(runs, bad)
    mesh_faults(runs, noisy, (
        ("lon exchange left out", dict(leave_out="lon exchange")),
        ("lon exchange left out after the predictor only",
         dict(leave_out="lon exchange after the predictor")),
        LAT_FAULT,
        ("ghosts one row and column narrower (2)",
         dict(halo=sharding.Halo(2, 2, 2)))), dev, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return {name: r[2] for name, r in runs.items()}


def backend_path(dev, card: str):
    """Phase 9: BASELINE #1 (backend='jnp') on the card: the plain per-step
    path, no kernel launch, finite fields."""
    cfg, res, counts, _ = run_argv(BACKEND_ARGV, dev)
    launched = {k: v for k, v in counts.items() if v}
    if not res.path.startswith("per-step (plain") or launched:
        raise AssertionError(f"baseline 1 took {res.path!r}, counts "
                             f"{launched}")
    for f in STATE_FIELDS:
        if not bool(torch.isfinite(getattr(res.state, f)).all()):
            raise AssertionError(f"non-finite {f} after baseline 1")
    print(f"  {cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz} backend="
          f"{cfg.backend}: {res.path}; {res.steps} steps, no kernel launch "
          f"(every counter 0), finite fields, max|V| "
          f"{res.records[-1]['max_wind']:.2f} m/s [{card}]", flush=True)


def same_state(a, b) -> bool:
    """Every field of two States equal bit for bit: the prognostic fields,
    the radiation caches, ``t`` and ``step``."""
    return (a.step == b.step and torch.equal(a.t, b.t)
            and bitwise_equal(a, b, STATE_FIELDS))


def nc_vars(path) -> dict:
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.array(v[:]) for k, v in f.variables.items()}


def metric_steps(out_dir) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def host_ms(fn, reps=IO_TIMING_REPS) -> float:
    """Host wall ms per call of ``fn``, the card synchronised around."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / reps


def io_path(dev, card: str, main_steady_ms: float):
    """Phase 10: config #3 through ``cli.run`` with an out-dir, continuous
    and split across a checkpoint, bit for bit; planted resume faults; #4
    on its 2x4 mesh split across a checkpoint saved from the gathered
    state; the io layer's times."""
    try:
        import matplotlib
        probe = f"matplotlib {matplotlib.__version__} importable"
    except ImportError as e:
        probe = f"matplotlib not importable ({e})"
    print(f"  probe (gates nothing): {probe}", flush=True)
    bad = []
    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        _io3(dev, card, main_steady_ms, root, bad)
        _io4(dev, card, root, bad)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if bad:
        raise AssertionError("; ".join(bad))


def _io3(dev, card, main_steady_ms, root, bad):
    cfg = cli.build_config(cli.make_parser().parse_args(MAIN_ARGV))
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    # 1. continuous, with every file
    reset_counts()
    ra = cli.run(cfg, device=dev, out_dir=a)
    counts = read_counts()
    if counts["predictor_masked"] != ra.steps \
            or counts["corrector_epilogue"] != ra.steps:
        bad.append(f"#3 with output: counts {counts} for {ra.steps} steps")
    n = len(ra.chunks)
    want = sorted(["constants.nc", "metrics.jsonl", "restart.npz"]
                  + [f"out_{i:04d}.nc" for i in range(n)])
    if n != 3 or sorted(os.listdir(a)) != want:
        bad.append(f"#3 with output: chunks {ra.chunks}, files "
                   f"{sorted(os.listdir(a))}, expected {want}")
    steps_a = metric_steps(a)
    if len(steps_a) != n or steps_a != sorted(set(steps_a)) \
            or steps_a[-1] != ra.steps:
        bad.append(f"#3 metrics.jsonl steps {steps_a}")
    ck = load_checkpoint(os.path.join(a, "restart.npz"), cfg, device=dev)
    last = nc_vars(os.path.join(a, f"out_{n - 1:04d}.nc"))
    s = ra.state
    nc_ok = all(np.array_equal(last[k][0], getattr(s, f).cpu().numpy())
                for k, f in NC_FIELDS.items())
    nc_ok &= bool(last["time"][0] == np.float32(float(s.t) / 86400.0))
    for k in ("TAIR", "PHI", "WWIND"):
        nz = s.u.shape[0] + (k == "WWIND")
        nc_ok &= last[k].shape == (1, nz) + tuple(s.u.shape[1:]) \
            and bool(np.isfinite(last[k]).all())
    steady = 1e3 * sum(r["wall_s"] for r in ra.records[1:]) \
        / sum(ra.chunks[1:])
    print(f"  #3 with --out-dir: {ra.steps} steps {ra.chunks}, files "
          f"{sorted(os.listdir(a))}; metrics steps {steps_a}; checkpoint "
          f"read back equal to the final state bit for bit: "
          f"{same_state(ck, s)}; last NetCDF file equal to it (prognostic "
          f"fields bit for bit, TAIR/PHI/WWIND finite): {nc_ok}; after the "
          f"first chunk {steady:.3f} ms/step with output against "
          f"{main_steady_ms:.3f} without (phase 5); wall ms of each chunk, "
          f"the NetCDF write after the one before included: "
          f"{[round(1e3 * r['wall_s'], 1) for r in ra.records]} [{card}]",
          flush=True)
    if not same_state(ck, s):
        bad.append("#3 checkpoint read back differs from the final state")
    if not nc_ok:
        bad.append("#3 last NetCDF file differs from the final state")

    # 2. split at half the horizon, resumed into the same out-dir
    r1 = cli.run(cfg.replace(sim_days=IO_SPLIT_DAYS), device=dev, out_dir=b)
    mid = os.path.join(root, "mid.npz")
    shutil.copy(os.path.join(b, "restart.npz"), mid)
    r2 = cli.run(cfg, device=dev, out_dir=b,
                 restart_from=os.path.join(b, "restart.npz"))
    steps_b = metric_steps(b)
    nb = len(r1.chunks) + len(r2.chunks)
    last_b = nc_vars(os.path.join(b, f"out_{nb - 1:04d}.nc"))
    same_nc = last_b.keys() == last.keys() and all(
        np.array_equal(last_b[k], v) for k, v in last.items())
    same = same_state(r2.state, s)
    print(f"  #3 split: {r1.steps} steps {r1.chunks}, then resumed at step "
          f"{r2.start_step} for {r2.steps} steps {r2.chunks}; final state "
          f"equal to the continuous run's bit for bit (every field, t, step, "
          f"radiation caches): {same}; metrics steps {steps_b}; last NetCDF "
          f"file equal to the continuous run's last: {same_nc} [{card}]",
          flush=True)
    if not same:
        bad.append("#3 split run differs from the continuous run: "
                   + str(state_diffs(r2.state, s)))
    if r2.start_step != r1.steps or r1.steps + r2.steps != ra.steps:
        bad.append(f"#3 resume started at {r2.start_step} and ran "
                   f"{r2.steps} steps after {r1.steps}, of {ra.steps}")
    if steps_b != sorted(set(steps_b)) or steps_b[0] != steps_a[0] \
            or steps_b[-1] != steps_a[-1] or r1.steps not in steps_b:
        bad.append(f"#3 split metrics steps {steps_b} against {steps_a}")
    if not same_nc:
        bad.append("#3 split run's last NetCDF file differs")
    shutil.rmtree(b)

    # 3. planted faults: each must break its gate
    with np.load(mid) as z:
        items = {k: z[k] for k in z.files}
    items["dpottdt_rad"] = np.zeros_like(items["dpottdt_rad"])
    zeroed = os.path.join(root, "zeroed.npz")
    np.savez(zeroed, **items)
    rz = cli.run(cfg, device=dev, restart_from=zeroed)
    broke = not same_state(rz.state, s)
    print(f"  planted fault, resume with the radiation cache zeroed: final "
          f"state differs: {broke}; max|dpott| "
          f"{float((rz.state.pott - s.pott).abs().max()):.3e} K", flush=True)
    if not broke:
        bad.append("resume with dpottdt_rad zeroed equals the sound run")
    retuned = cli.build_config(cli.make_parser().parse_args(
        MAIN_ARGV + ["--diff", "77.0"]))
    try:
        cli.run(retuned, device=dev, restart_from=mid)
        refused = "not refused"
    except ValueError as e:
        refused = str(e)
    ok = "numerics.diff_uv" in refused
    print(f"  planted fault, resume with --diff 77: refused naming "
          f"numerics.diff_uv: {ok}", flush=True)
    if not ok:
        bad.append(f"resume with --diff 77: {refused}")
    branch = os.path.join(root, "branch")
    cli.run(retuned, device=dev, restart_from=mid, force_resume=True,
            out_dir=branch, no_nc=True)
    with open(os.path.join(branch, "forced_branch.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    ok = len(recs) == 1 and recs[0]["step"] == r1.steps and \
        recs[0]["mismatch"]["numerics.diff_uv"]["current"] == 77.0
    print(f"  planted fault, --force-resume with --diff 77: "
          f"forced_branch.jsonl {recs}", flush=True)
    if not ok:
        bad.append(f"forced resume recorded {recs}")

    # 4. times at #3
    path = os.path.join(root, "t3.npz")
    save_ms = host_ms(lambda: save_checkpoint(path, s, cfg))
    load_ms = host_ms(lambda: load_checkpoint(path, cfg, device=dev))
    writer = NCWriter(os.path.join(root, "nc"))
    writer.write(s, ra.grid, ra.forcing)          # constants.nc once
    nc_ms = host_ms(lambda: writer.write(s, ra.grid, ra.forcing))
    mb = os.path.getsize(path) / 1e6
    nc_mb = os.path.getsize(os.path.join(root, "nc", "out_0001.nc")) / 1e6
    print(f"  #3 io times, host ms per call (synchronised), mean of "
          f"{IO_TIMING_REPS}: save_checkpoint {save_ms:.1f} ({mb:.1f} MB), "
          f"load_checkpoint to the card {load_ms:.1f}, NCWriter.write "
          f"{nc_ms:.1f} ({nc_mb:.1f} MB) [{card}]", flush=True)


def _io4(dev, card, root, bad):
    cfg = cli.build_config(cli.make_parser().parse_args(BLOCKING_ARGV))
    c, d = os.path.join(root, "c"), os.path.join(root, "d")
    rc = cli.run(cfg, device=dev, out_dir=c, no_nc=True)
    r1 = cli.run(cfg.replace(sim_days=IO4_SPLIT_DAYS), device=dev,
                 out_dir=d, no_nc=True)
    r2 = cli.run(cfg, device=dev, out_dir=d, no_nc=True,
                 restart_from=os.path.join(d, "restart.npz"))
    same = same_state(r2.state, rc.state)
    print(f"  #4 {rc.path}: {rc.steps} steps {rc.chunks} continuous; split "
          f"{r1.steps} steps, saved from the gathered state, resumed onto "
          f"the mesh at step {r2.start_step} for {r2.steps} steps; final "
          f"state equal bit for bit: {same} [{card}]", flush=True)
    if not same:
        bad.append("#4 split run differs from the continuous run: "
                   + str(state_diffs(r2.state, rc.state)))
    if r2.start_step != r1.steps or r1.steps + r2.steps != rc.steps \
            or "sharded" not in r2.path:
        bad.append(f"#4 resume: {r2.path}, started at {r2.start_step}, "
                   f"{r2.steps} steps after {r1.steps}, of {rc.steps}")
    shutil.rmtree(d)
    path = os.path.join(c, "restart.npz")
    load_ms = host_ms(lambda: load_checkpoint(path, cfg, device=dev))
    save_ms = host_ms(lambda: save_checkpoint(path, rc.state, cfg))
    print(f"  #4 io times, host ms per call (synchronised), mean of "
          f"{IO_TIMING_REPS}: save_checkpoint {save_ms:.1f} "
          f"({os.path.getsize(path) / 1e6:.1f} MB), load_checkpoint to the "
          f"card {load_ms:.1f} [{card}]", flush=True)


def cli_out(argv) -> str:
    """``cli.main(argv)``'s standard output, printed as it ran; raises on a
    non-zero return."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("".join(f"  | {line}\n" for line in out.splitlines()), end="",
          flush=True)
    if rc != 0:
        raise AssertionError(f"{argv} returned {rc}")
    return out


def cli_json(argv) -> dict:
    """The one JSON line that ``cli.main(argv)`` prints last."""
    return json.loads(cli_out(argv).splitlines()[-1])


def bench_counts(argv, want: dict, bad: list) -> dict:
    """``cli_json(argv)`` with every counter set to 0 just before and read
    just after; a count other than ``want``'s (0 where it names none) goes
    into ``bad``."""
    reset_counts()
    rec = cli_json(argv)
    counts = read_counts()
    full = collections.Counter(want)
    if counts != full:
        bad.append(f"{argv}: counts {counts}, expected {full}")
    print(f"  counts {({k: v for k, v in counts.items() if v})}",
          flush=True)
    return rec


def budget_identities(dev, card: str, bad: list):
    """The budget identities at #3 (``backend='jnp'``, fp32) on the card."""
    from climate_model_tpu_torch.bench.budget import make_budget_scan
    cfg = baseline_config(3).replace(backend="jnp")
    state, forcing, grid = initialize(cfg, device=dev)
    t = time.perf_counter()
    _, rec = make_budget_scan(cfg, BUDGET_STEPS)(state, grid, forcing)
    rec = {k: v.double().cpu().numpy() for k, v in rec.items()}
    wall = time.perf_counter() - t
    W, E = rec["w_total"][-1], rec["e_total"][-1]
    evap = rec["w_srf_expect"]
    resid = np.abs(rec["w_srf"] - evap)
    leak = rec["w_dyn"] + rec["w_trb"] + rec["w_mic"]
    e_resid = np.abs(rec["e_srf"] - rec["e_srf_expect"])
    checks = [
        (np.isfinite(W) and evap.min() > 0, f"W {W:.6e} kg finite, "
         f"evaporation {evap.min():.4e} kg a step or more > 0"),
        (resid.max() < 1e-6 * W, f"surface water identity "
         f"{resid.max():.4e} < 1e-6 W"),
        (abs((rec["w_srf"] - evap).sum()) < 5e-3 * evap.sum(),
         f"summed {abs((rec['w_srf'] - evap).sum()):.4e} < 5e-3 of "
         f"evaporation {evap.sum():.4e}"),
        (abs(leak.sum()) < 0.02 * evap.sum(),
         f"water leak {abs(leak.sum()):.4e} < 0.02 of evaporation"),
        (e_resid.max() < 1e-6 * E, f"surface energy identity "
         f"{e_resid.max():.4e} < 1e-6 E ({E:.6e} J)"),
        (np.max(np.abs(rec["e_mic"])) < 1e-6 * E, f"microphysics energy "
         f"{np.max(np.abs(rec['e_mic'])):.4e} < 1e-6 E")]
    for ok, what in checks:
        print(f"  {'ok ' if ok else 'BAD'} {what}", flush=True)
        if not ok:
            bad.append(f"budget: {what}")
    print(f"  budget: {BUDGET_STEPS} steps of #3 (backend=jnp, fp32) in "
          f"{wall:.2f}s [{card}]", flush=True)


def bench_path(dev, card: str, timing: dict):
    """Phase 11: the bench and profile subcommands on the card."""
    bad = []
    kind = torch.cuda.get_device_name(dev)
    kern_ms = {k: timing[k]["ms"] for k in ("predictor_masked",
                                            "corrector_epilogue")}
    step_dev_ms = sum(kern_ms.values())

    # throughput: one masked predictor and one epilogue corrector a step
    cfg3 = baseline_config(3)
    steps = cli.make_parser().parse_args(BENCH_ARGV).steps * BENCH_CHUNKS
    every = cfg3.physics.rad_every_steps
    rec = bench_counts(BENCH_ARGV, dict(
        predictor_masked=steps, corrector_epilogue=steps,
        radiation_refreshes=sum(1 for k in range(steps) if k % every == 0)),
        bad)
    ok = rec["step_time_ms"] >= STEP_FLOOR * step_dev_ms
    print(f"  bench: {rec['step_time_ms']} ms/step, {rec['value']:.6e} "
          f"grid-points/s, vs_hbm_roofline {rec['vs_hbm_roofline']}, "
          f"vs_fp32_peak {rec['vs_fp32_peak']}; the two kernels' device "
          f"time {step_dev_ms:.4f} ms a step (phase 4) [{card}]",
          flush=True)
    if not ok:
        bad.append(f"bench step {rec['step_time_ms']} ms < {STEP_FLOOR} x "
                   f"the kernels' device time {step_dev_ms:.4f} ms")
    if not 0 < rec["vs_hbm_roofline"] <= 1.05:
        bad.append(f"vs_hbm_roofline {rec['vs_hbm_roofline']}")
    if rec["device"] != kind:
        bad.append(f"bench device {rec['device']!r}, card {kind!r}")

    # micro: the same kernels as phase 4, chained
    rec = cli_json(MICRO_ARGV)
    for key, k in (("pred_ms", "predictor_masked"),
                   ("corr_ms", "corrector_epilogue")):
        ratio = rec[key] / kern_ms[k]
        print(f"  bench --micro {key} {rec[key]} ms against phase 4's {k} "
              f"{kern_ms[k]:.4f} ms: {ratio:.3f} [{card}]", flush=True)
        if abs(ratio - 1.0) > MICRO_TOL:
            bad.append(f"micro {key} {rec[key]} not within {MICRO_TOL} of "
                       f"{kern_ms[k]:.4f}")

    # profile: the kernel rows, then the plain splits with a trace
    out = cli_out(PROFILE_ARGV)
    for row in ("predictor_kernel", "corrector_kernel(+physics epilogue)",
                "radiation_amortized", "total_per_step"):
        if row not in out:
            bad.append(f"profile --baseline 3 lacks the row {row}")
    tdir = tempfile.mkdtemp(prefix="cm_trace_")
    try:
        out = cli_out(PROFILE_JNP_ARGV + ["--trace-dir", tdir])
        trace = os.path.join(tdir, "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        print(f"  profile trace: {size} bytes", flush=True)
        if not size:
            bad.append("profile --trace-dir wrote no trace")
        for row in ("dynamics", "surface", "turbulence", "microphysics"):
            if row not in out:
                bad.append(f"profile --backend jnp lacks the row {row}")
    finally:
        shutil.rmtree(tdir, ignore_errors=True)

    # stability over 10 radiation intervals
    rec = cli_json(STABILITY_ARGV)
    if not (rec["stable"] and rec["max_wind"] < MAX_WIND
            and rec["steps_run"] == cli.make_parser().parse_args(
                STABILITY_ARGV).steps):
        bad.append(f"stability: {rec}")

    budget_identities(dev, card, bad)

    # scaling: #4 unsharded against its 2x4 mesh with halo overlap
    cfg4 = baseline_config(4)
    n_sh = cfg4.sharding.mesh_lat * cfg4.sharding.mesh_lon
    steps = cli.make_parser().parse_args(SCALING_ARGV).steps * SCALING_RUNS
    strips = cfg4.sharding.mesh_lon * (cfg4.sharding.mesh_lat - 1)
    launches, slabs = halo_copies(cfg4.replace(sharding=dataclasses.replace(
        cfg4.sharding, halo_overlap=True)), ranks=False)
    want = dict(predictor_masked=steps, corrector_epilogue=steps,
                radiation_refreshes=SCALING_RUNS * (1 + n_sh),
                halo_copy_launches=steps * launches,
                halo_copy_slabs=steps * slabs)
    for fn in ("predictor", "corrector"):
        want.update({f"{fn}_shard": n_sh * steps,
                     f"{fn}_south_strip": strips * steps,
                     f"{fn}_north_strip": strips * steps})
    rec = bench_counts(SCALING_ARGV, want, bad)
    print(f"  scaling: gps 1x1 {rec['gps_1dev']:.6e}, mesh "
          f"{rec['gps_ndev']:.6e}, ratio {rec['gps_ratio']} "
          f"({rec['metric']}) [{card}]", flush=True)
    if not (rec["gps_1dev"] > 0 and rec["gps_ndev"] > 0):
        bad.append(f"scaling: {rec}")

    # Euler and RK4 on the plain backend
    for stepper in ("euler", "rk4"):
        argv = STEPPER_ARGV + [stepper]
        cfg, res, counts, _ = run_argv(argv, dev)
        launched = {k: v for k, v in counts.items() if v}
        if launched or cfg.numerics.time_stepping != stepper:
            bad.append(f"{argv}: {cfg.numerics.time_stepping}, counts "
                       f"{launched}")
        print(f"  run --stepper {stepper}: {res.steps} steps on {res.path} "
              f"[{card}]", flush=True)
        try:
            sanity(res.state, res.grid, initialize(cfg, device=dev)[0])
        except AssertionError as e:
            bad.append(f"{stepper}: {e}")
    if bad:
        raise AssertionError("; ".join(bad))


VARIANTS = {
    # name: (counter, path that launches it, errors key)
    "predictor": ("predictor", "per-step", "predictor"),
    "corrector": ("corrector", "per-step", "corrector"),
    "predictor_masked": ("predictor_masked", "packed scan",
                         "predictor_masked"),
    "corrector_epilogue": ("corrector_epilogue", "packed scan",
                           "corrector_epilogue"),
}


def lat_zero_everywhere(side):
    """A lat shift that takes zero rows at every shard edge (the lat
    exchange left out)."""
    def shift(a):
        zero = torch.zeros_like(a[..., :1, :])
        return (torch.cat([zero, a[..., :-1, :]], dim=-2) if side == "south"
                else torch.cat([a[..., 1:, :], zero], dim=-2))
    return shift


def wall_on_every_shard(v):
    return torch.cat([torch.zeros_like(v[..., :1, :]), v[..., 1:, :]],
                     dim=-2)


# planted faults of the per-operator halo path: replacements of shift
# primitives of dycore/boundaries.py
JNP_MESH_FAULTS = {
    "lon exchange left out (west/east roll within the block)": dict(
        west=lambda a: torch.roll(a, 1, dims=-1),
        east=lambda a: torch.roll(a, -1, dims=-1)),
    "lat exchange left out (zero rows at every shard edge)": dict(
        south_zero=lat_zero_everywhere("south"),
        south_clamp=lat_zero_everywhere("south"),
        north_zero=lat_zero_everywhere("north"),
        north_clamp=lat_zero_everywhere("north")),
    "v wall on every lat shard": dict(enforce_v_walls=wall_on_every_shard),
}


@contextlib.contextmanager
def planted(module, **attrs):
    """The attributes ``attrs`` of ``module`` replaced for the block."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, fn in attrs.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def jnp_mesh_path(noisy, dev, card: str):
    """Phase 12: BASELINE #4 on the plain backend on its 2x4 mesh in one
    process (shard_map and auto) and unsharded, counted and compared; the
    planted faults from the noisy #4 state."""
    bad = []
    runs = {}
    for name, argv in (("shard_map", JNP_MESH_ARGV), ("auto", JNP_AUTO_ARGV),
                       ("unsharded", JNP_UNSHARDED_ARGV)):
        halo.make_sharded_step_fn.shifts = 0
        halo.make_sharded_step_fn.waited_s = 0.0
        runs[name] = run_argv(argv, dev)
        cfg, res, counts, steady = runs[name]
        launched = {k: v for k, v in counts.items()
                    if k not in PLAIN_COUNTERS and v}
        shifts = halo.make_sharded_step_fn.shifts
        waited = halo.make_sharded_step_fn.waited_s
        print(f"  {name}: {res.path}; {res.steps} steps {res.chunks}, "
              f"{1e3 * res.wall_s / res.steps:.3f} ms/step, after the first "
              f"chunk {steady:.3f} ms/step; {shifts / res.steps:.1f} shifts "
              f"a step (a rendezvous each, and one at each chunk's end), "
              f"{1e3 * waited / res.steps:.3f} ms a step of a shard "
              f"thread's waits at them; "
              f"kernel launches {launched or 0}; plain physics "
              f"{ {k: counts[k] for k in PLAIN_COUNTERS} } [{card}]",
              flush=True)
        if launched:
            bad.append(f"{name}: kernel launches {launched} on the plain "
                       "path")
        want_path = {"shard_map": "sharded per-step (plain PyTorch, "
                                  "per-operator halos)  mesh=2x4",
                     "auto": "GSPMD auto: the global program on 1 device",
                     "unsharded": "per-step (plain PyTorch dynamics"}[name]
        if not res.path.startswith(want_path):
            bad.append(f"{name} took {res.path!r}")
        if (shifts > 0) != (name == "shard_map"):
            bad.append(f"{name}: {shifts} shifts")
    s0, _, _ = initialize(runs["shard_map"][0], device=dev)
    sanity(runs["shard_map"][1].state, runs["shard_map"][1].grid, s0)
    base = runs["unsharded"][1]
    for name in ("shard_map", "auto"):
        res = runs[name][1]
        if res.dts != base.dts or res.steps != base.steps:
            bad.append(f"{name}: {res.steps} steps, dts {res.dts}; "
                       f"unsharded {base.steps}, {base.dts}")
        per = state_diffs(res.state, base.state)
        same = bitwise_equal(res.state, base.state, STATE_FIELDS)
        print(f"  {name} vs unsharded: bitwise equal {same}; "
              + show({f: per[f] for f in JNP_MESH_TOL}, JNP_MESH_TOL),
              flush=True)
        if name == "auto" and not same:
            bad.append("auto in one process differs from unsharded")
        bad += [f"{name} vs unsharded: {x} over its bound"
                for x in over({f: per[f] for f in JNP_MESH_TOL},
                              JNP_MESH_TOL)]
    cfg = runs["shard_map"][0]
    _, s0, f0, g0 = noisy
    g0 = g0.replace(dt=base.dts[0])
    cfg1 = runs["unsharded"][0]
    want = make_chunk_runner(cfg1, JNP_FAULT_STEPS)(s0, g0, f0)
    for fault, prims in (("none (sound)", {}), *JNP_MESH_FAULTS.items()):
        with planted(bc, **prims):
            got = make_chunk_runner(cfg, JNP_FAULT_STEPS)(s0, g0, f0)
        per = state_diffs(got, want)
        per = {f: per[f] for f in JNP_MESH_TOL}
        same = bitwise_equal(got, want, STATE_FIELDS)
        print(f"  noisy #4 state, {JNP_FAULT_STEPS} steps, shard_map, planted "
              f"fault: {fault}; vs unsharded, bitwise equal {same}: "
              + show(per, JNP_MESH_TOL), flush=True)
        if fault == "none (sound)":
            bad += [f"sound shard_map run from the noisy state: {x} over its "
                    "bound" for x in over(per, JNP_MESH_TOL)]
        elif not over(per, JNP_MESH_TOL):
            bad.append(f"the {fault} stays within every bound")
    if bad:
        raise AssertionError("; ".join(bad))


def gate_config(baseline: int, rad_every):
    """Config ``baseline`` on a 1x1 mesh; radiation every ``rad_every``
    steps (None: the preset's hourly cadence)."""
    cfg = baseline_config(baseline)
    cfg = cfg.replace(sharding=dataclasses.replace(cfg.sharding, mesh_lat=1,
                                                   mesh_lon=1))
    if rad_every is not None:
        cfg = cfg.replace(physics=dataclasses.replace(
            cfg.physics, rad_every_steps=rad_every, rad_every_hours=0.0))
    return cfg


def gate_faults(cfg) -> dict:
    """The planted faults of the kernel path: replacements of names that
    the eager packed scan (``model.run_packed`` on ``model.PackedStep``)
    calls."""
    refresh = radiation.radiation_step
    no_turb = phys_with(cfg, turbulence=False)
    return {GATE_FAULTS[0]: dict(radiation_step=lambda s, g, f, c: (
                refresh(s, g, f, c) if s.step == 0 else s)),
            GATE_FAULTS[1]: dict(corrector=lambda *a, phys, **k: (
                fs.corrector(*a, phys=no_turb, **k)))}


def gate_path(dev, card: str):
    """Phase 13: for each of GATE_RUNS, the kernel path and the plain path
    from the same initial state, counted and compared field by field; each
    planted fault of the kernel path against the plain run."""
    bad = [f"GATE_TOL[{b}] {f} {tol[f]} above the reference's "
           f"{REF_GATE_TOL[f]}" for b, tol in GATE_TOL.items()
           for f in over(tol, REF_GATE_TOL)]
    for baseline, n, rad_every in GATE_RUNS:
        tol = GATE_TOL[baseline]
        cfg = gate_config(baseline, rad_every)
        every = cfg.physics.rad_every_steps
        refreshes = sum(1 for k in range(n) if k % every == 0)
        s0, f0, g0 = initialize(cfg, device=dev)
        gc = cfg.grid
        label = f"#{baseline} ({gc.nx}x{gc.ny}x{gc.nz}), {n} steps"
        runs = [("plain", cfg.replace(backend="jnp"), {}),
                ("kernel", cfg, {}),
                *((f, cfg, p) for f, p in gate_faults(cfg).items())]
        out = {}
        for name, c, plant in runs:
            reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            # eager: the faults replace names the eager step calls (the
            # compiled chunk is held to the eager loop in phase 17)
            with planted(model, **plant):
                out[name] = make_chunk_runner(c, n, graphs=False)(s0, g0,
                                                                  f0)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / n
            counts = read_counts()
            launched = {k: v for k, v in counts.items()
                        if k not in PLAIN_COUNTERS and v}
            print(f"  {label}, {name} path: {ms:.3f} ms/step (radiation "
                  f"every {every} steps); kernel launches {launched or 0}, "
                  f"radiation refreshes {counts['radiation_refreshes']} "
                  f"[{card}]", flush=True)
            if name == "plain" and (launched or counts[
                    "radiation_refreshes"] != refreshes):
                bad.append(f"{label}, plain path: counts {counts}")
            if name == "kernel":
                want = collections.Counter()
                want.update(predictor_masked=n, corrector_epilogue=n,
                            radiation_refreshes=refreshes)
                if counts != want:
                    bad.append(f"{label}, kernel path: counts {counts}, "
                               f"expected {want}")
            if name == "plain":
                continue
            per = state_diffs(out[name], out["plain"])
            print(f"  {label}, {name} vs plain: " + show(per, tol),
                  flush=True)
            if name == "kernel":
                bad += [f"{label}: kernel vs plain {x} over its bound"
                        for x in over(per, tol)]
            elif not over(per, tol):
                bad.append(f"{label}: the {name} stays within every bound")
            elif name == GATE_FAULTS[0]:
                rad, fluxes = STALE_MUST_BREAK
                broke = over(per, tol)
                if rad not in broke or not set(fluxes) & set(broke):
                    bad.append(f"{label}: stale radiation caches break "
                               f"{broke} only")
        del out
    if bad:
        raise AssertionError("; ".join(bad))


def baseline5_path(dev, card: str) -> dict:
    """Phase 14: BASELINE #5 unsharded for 0.25 days through the run
    command; on its 4x8 mesh in both schedules against the unsharded grid;
    the planted lat fault from the noisy #5 state; the two kernels of the
    main path at #5's grid against their plain versions, timed. Returns the
    day run's counts, the kernels' errors and their timing."""
    bad = []
    with peak_memory(dev) as peak:
        cfg, res, counts, steady = run_argv(B5_DAY_ARGV, dev)
    every = cfg.physics.rad_every_steps
    want = collections.Counter()
    want.update(predictor_masked=res.steps, corrector_epilogue=res.steps,
                radiation_refreshes=sum(1 for k in range(res.steps)
                                        if k % every == 0))
    print(f"  unsharded 0.25 days: {res.path}; {res.steps} steps "
          f"{res.chunks}, dt {res.dts}, {1e3 * res.wall_s / res.steps:.3f} "
          f"ms/step, after the first chunk {steady:.3f} ms/step; {peak}; "
          f"counts "
          f"{({k: v for k, v in counts.items() if v})} [{card}]",
          flush=True)
    if counts != want:
        bad.append(f"#5 unsharded: counts {counts}, expected {want}")
    # every run of the phase starts from #5's initial state
    s0, _, _ = initialize(cfg, device=dev)
    sanity(res.state, res.grid, s0)
    # the record at the reference's step (the horizon ends one step later)
    rec = next((r for r in res.records
                if r["step"] == REF5_FIRST_LINE["step"]), res.records[-1])
    print("  metrics record beside the reference's first line "
          "(out_clim_025/metrics.jsonl; a reading, not a gate): " + ", ".join(
              f"{k} {rec[k]!r} / {v!r}" for k, v in REF5_FIRST_LINE.items()),
          flush=True)
    errs, timing = time_b5_kernels(res, cfg, card, bad)
    del res

    runs = mesh_runs((("overlap", B5_OVERLAP_ARGV), ("blocking", B5_ARGV),
                      ("unsharded", B5_UNSHARDED_ARGV)), dev, card, bad)
    if runs["overlap"][1].steps != B5_STEPS:
        bad.append(f"#5 on 4x8: {runs['overlap'][1].steps} steps, expected "
                   f"{B5_STEPS}")
    sanity(runs["overlap"][1].state, runs["overlap"][1].grid, s0)
    del s0
    mesh_compare(runs, bad)
    mesh_faults(runs, noisy_state(5, dev), (LAT_FAULT,), dev, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(counts=counts, errs=errs, timing=timing)


def time_b5_kernels(res, cfg, card: str, bad: list):
    """The masked predictor and the epilogue corrector on the final state of
    the #5 day run, against their plain versions (FIELD_TOL, EPI_TOL) and
    timed beside their bound."""
    s, g, f = res.state, res.grid, res.forcing
    dt, vm = g.dt, fs.wall_mask(g.ny, torch.float32, s.device)
    num = cfg.numerics
    kw = dict(with_rad=cfg.physics.radiation,
              with_diff=bool(num.diff_uv or num.diff_pott or num.diff_moist))
    phys = phys_epilogue_tuple(cfg)
    pred = fs.fused_substep_plain(s, None, g, f, dt, vmask=vm, **kw)
    calls = {
        "predictor_masked": (
            lambda: fs.predictor(s, g, f, dt, vmask=vm, **kw),
            lambda: fs.fused_substep_plain(s, None, g, f, dt, vmask=vm,
                                           **kw),
            (s, None, None), FIELD_TOL),
        "corrector_epilogue": (
            lambda: fs.corrector(pred, s, g, f, dt, phys=phys, vmask=vm,
                                 **kw),
            lambda: fs.fused_substep_plain(pred, s, g, f, dt, phys=phys,
                                           vmask=vm, **kw),
            (pred, s, phys), EPI_TOL)}
    errs, timing = {}, {}
    for kname, (kern, plain, (e, b, ph), tol) in calls.items():
        errs[kname] = field_errors(kern(), plain(), tol)
        print(f"  {kname} at {tuple(s.u.shape)} max|kernel-plain|: "
              + show(errs[kname], tol), flush=True)
        bad += [f"{kname} at #5's grid: {x} over its bound"
                for x in over(errs[kname], tol)]
        # the plain versions take 40-60 ms a call at #5: 10 calls suffice
        timing[kname] = kernel_timing(
            f"{kname} at {tuple(s.u.shape)}", kern, plain,
            substep_bound_ms(e, b, g, f, kern(), phys=ph, vmask=vm), card,
            n=10, shape=tuple(s.u.shape))
    return errs, timing


# ---------------------------------------------------------------------------
# The climate gates: pure functions over metrics records (the dicts of a
# run's metrics.jsonl, or record_of a StepDiagnostics of either package)
# ---------------------------------------------------------------------------

# metrics.jsonl key -> StepDiagnostics field
RECORD_FIELDS = {"step": "step", "t_days": "t", "max_wind": "max_wind",
                 "mean_colp": "mean_colp", "mean_pott": "mean_tair_proxy",
                 "total_water": "total_water", "toa_net_sw": "toa_net_sw",
                 "olr": "olr", "energy": "energy", "evap_rate": "evap_rate",
                 "total_rain": "total_rain"}
EQUILIBRIUM_BOUNDS = {"end_over_peak": 0.75, "end_imb": 12.0,
                      "dpott_dt": 0.03, "rain": 10.0,
                      "rain_over_evap": (0.55, 1.35)}


def record_of(d) -> dict:
    """A StepDiagnostics of the port or of the JAX package (host floats or
    0-d arrays) as a metrics record."""
    rec = {k: float(getattr(d, f)) for k, f in RECORD_FIELDS.items()}
    rec["step"] = int(rec["step"])
    rec["t_days"] /= 86400.0
    return rec


def closure_residuals(records, area_total: float) -> dict:
    """The closure gate's arithmetic (test_climate_sanity.py:72-90) over
    consecutive records: for each pair, d(energy)/dt - (toa_net_sw - olr)
    at the later one in W/m2; the evaporation integrated by the trapezoid
    rule over ``area_total`` (m2, the grid's) against the change of total
    water (kg) from the first record to the last."""
    resid, evap_int = [], 0.0
    for a, b in zip(records[:-1], records[1:]):
        dt = (b["t_days"] - a["t_days"]) * 86400.0
        resid.append((b["energy"] - a["energy"]) / dt
                     - (b["toa_net_sw"] - b["olr"]))
        evap_int += 0.5 * (b["evap_rate"] + a["evap_rate"]) * dt * area_total
    dwater = records[-1]["total_water"] - records[0]["total_water"]
    return dict(resid=resid, mean=float(np.mean(resid)),
                max_abs=float(np.max(np.abs(resid))), dwater=dwater,
                evap_int=evap_int,
                water_err=abs(dwater - evap_int) / evap_int)


def closure_failures(cl: dict) -> list:
    """What of ``closure_residuals``'s readings breaks CLOSURE_BOUNDS."""
    b = CLOSURE_BOUNDS
    bad = [f"energy closure residual {r:.2f} W/m2 in chunk {i + 1}"
           for i, r in enumerate(cl["resid"]) if not abs(r) < b["resid"]]
    if not abs(cl["mean"]) < b["mean"]:
        bad.append(f"mean energy closure residual {cl['mean']:.2f} W/m2")
    if not (cl["dwater"] > 0.0 and cl["evap_int"] > 0.0
            and cl["water_err"] < b["water"]):
        bad.append(f"water closure: change {cl['dwater']:.4e} kg against "
                   f"integrated evaporation {cl['evap_int']:.4e} kg")
    return bad


def equilibrium_verdict(records) -> tuple:
    """The equilibrium gate (test_climate_sanity.py:127-143) over the
    records after each chunk (not the initial state's). Returns (readings,
    failures against EQUILIBRIUM_BOUNDS)."""
    imb = [r["toa_net_sw"] - r["olr"] for r in records]
    a, z = records[-4], records[-1]
    days = z["t_days"] - a["t_days"]
    rd = dict(peak_imb=max(abs(x) for x in imb),
              end_imb=abs(float(np.mean(imb[-3:]))),
              dpott_dt=(z["mean_pott"] - a["mean_pott"]) / days,
              rain=z["total_rain"],
              rain_rate=(z["total_rain"] - a["total_rain"]) / days,
              evap_rate=float(np.mean([r["evap_rate"] * 86400.0
                                       for r in records[-4:]])))
    b = EQUILIBRIUM_BOUNDS
    lo, hi = b["rain_over_evap"]
    checks = [
        (rd["end_imb"] < b["end_over_peak"] * rd["peak_imb"],
         f"end imbalance {rd['end_imb']:.3f} not under "
         f"{b['end_over_peak']} of the peak {rd['peak_imb']:.3f} W/m2"),
        (rd["end_imb"] < b["end_imb"],
         f"end imbalance {rd['end_imb']:.3f} W/m2 not under {b['end_imb']}"),
        (abs(rd["dpott_dt"]) < b["dpott_dt"],
         f"POTT trend {rd['dpott_dt']:.4f} K/day not under {b['dpott_dt']}"),
        (rd["rain"] > b["rain"],
         f"accumulated rain {rd['rain']:.3f} kg/m2 not over {b['rain']}"),
        (lo * rd["evap_rate"] < rd["rain_rate"] < hi * rd["evap_rate"],
         f"rain rate {rd['rain_rate']:.4f} outside ({lo}, {hi}) x the "
         f"evaporation {rd['evap_rate']:.4f} kg/m2/day")]
    return rd, [what for ok, what in checks if not ok]


def _rain_over_evap(rs) -> float:
    """Rain accumulated from the first record to the last over the mean
    evaporation of the records, both in kg/m2/day."""
    rain = (rs[-1]["total_rain"] - rs[0]["total_rain"]) \
        / (rs[-1]["t_days"] - rs[0]["t_days"])
    return rain / (86400.0 * float(np.mean([r["evap_rate"] for r in rs])))


def window_figures(records, steps=CONT_WINDOW_STEPS) -> dict:
    """The figures of CONT_WINDOW_BANDS over the records at ``steps``
    (first and last, inclusive); the water gain is from the first of all
    records. Raises if no record falls on the window's last step."""
    w = [r for r in records if steps[0] <= r["step"] <= steps[1]]
    if not w or w[-1]["step"] != steps[1]:
        raise AssertionError(f"no record at step {steps[1]}: the records' "
                             "steps differ from the reference's")
    colp = [r["mean_colp"] for r in w]
    return dict(records=len(w),
                mean_pott=float(np.mean([r["mean_pott"] for r in w])),
                toa_imbalance=float(np.mean([r["toa_net_sw"] - r["olr"]
                                             for r in w])),
                rain_over_evap=_rain_over_evap(w),
                water_gain=w[-1]["total_water"] - records[0]["total_water"],
                mean_colp_lo=min(colp), mean_colp_hi=max(colp))


def annual_figures(records, imb_days=(120, 365), re_days=(180, 365)
                   ) -> dict:
    """A year's figures: the mean and (population) standard deviation of
    the TOA imbalance (toa_net_sw - olr) and the mean of mean POTT over the
    records with t_days in ``imb_days``; rain/evap over ``re_days``; the
    drift of mean COLP, first record to last; the peak wind; the least dt
    and its ratio to the first."""
    def inside(days):
        return [r for r in records if days[0] <= r["t_days"] <= days[1]]
    w = inside(imb_days)
    imb = np.array([r["toa_net_sw"] - r["olr"] for r in w])
    dts = [r["dt"] for r in records]
    return dict(days=records[-1]["t_days"], records=len(records),
                toa_mean=float(imb.mean()), toa_std=float(imb.std()),
                pott_mean=float(np.mean([r["mean_pott"] for r in w])),
                rain_over_evap=_rain_over_evap(inside(re_days)),
                colp_drift=records[-1]["mean_colp"] - records[0]["mean_colp"],
                peak_wind=max(r["max_wind"] for r in records),
                min_dt=min(dts), min_dt_ratio=min(dts) / dts[0])


def band_failures(values: dict, bands: dict) -> list:
    """Each value of ``bands``' keys outside its (lo, hi), inclusive."""
    return [f"{k} {values[k]!r} outside [{lo!r}, {hi!r}]"
            for k, (lo, hi) in bands.items()
            if not lo <= values[k] <= hi]


# ---------------------------------------------------------------------------
# Phase 15: the climate gates on the card
# ---------------------------------------------------------------------------

def climate_config(gate: str, backend="pallas", dtype="float32"):
    """The reference's config of the gate ``gate`` of CLIMATE_GATES: full
    physics on its grid, radiation every n steps, its diffusion."""
    (nx, ny, nz), every, diff = CLIMATE_GATES[gate]
    k = default_diffusion(nx) if diff is None else diff
    return ModelConfig(
        grid=GridConfig(nx=nx, ny=ny, nz=nz),
        physics=PhysicsConfig(microphysics=True, radiation=True,
                              surface=True, turbulence=True,
                              rad_every_steps=every),
        numerics=NumericsConfig(diff_uv=k, diff_pott=k, diff_moist=k),
        dtype=dtype, backend=backend)


def area_total(grid, nx: int) -> float:
    """The grid's area in m2 (the closure gate's ``area_tot``)."""
    return float(grid.area.double().sum()) * nx


def chunk_records(cfg, chunks: int, steps: int, dev, state=None,
                  diag=diagnostics):
    """``chunks`` chunks of ``steps`` steps of ``model.make_run_fn`` from
    the initial state (or ``state``), ``diag`` of the state before the
    first chunk and after each as metrics records; raises on a non-finite
    state. Returns (records, state, grid, forcing)."""
    s0, forcing, grid = initialize(cfg, device=dev)
    state = s0 if state is None else state
    run = model.make_run_fn(cfg, steps, donate=False)
    records = [record_of(diag(state, grid, forcing, cfg))]
    for _ in range(chunks):
        state = run(state, grid, forcing)
        d = diag(state, grid, forcing, cfg)
        if d.nan_flag:
            raise AssertionError(f"non-finite state at step {d.step}")
        records.append(record_of(d))
    return records, state, grid, forcing


def counted(label: str, cfg, steps: int, fn, card: str, bad: list):
    """``fn()`` with every counter set to 0 just before and read just
    after, timed (ms/step over ``steps``). The kernel path must make one
    masked predictor and one epilogue corrector a step and nothing else,
    the plain path no launch; both refresh radiation at every step k with
    k % rad_every_steps == 0 (none without radiation). Returns (fn's
    result, counts)."""
    every = cfg.physics.rad_every_steps
    refreshes = (sum(1 for k in range(steps) if k % every == 0)
                 if cfg.physics.radiation else 0)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / steps
    counts = read_counts()
    launched = {k: v for k, v in counts.items()
                if k not in PLAIN_COUNTERS and v}
    print(f"  {label}: {steps} steps, {ms:.3f} ms/step; kernel launches "
          f"{launched or 0}, plain physics "
          f"{({k: counts[k] for k in PLAIN_COUNTERS if counts[k]}) or 0} "
          f"[{card}]", flush=True)
    want = collections.Counter()
    if cfg.backend == "pallas":
        want.update(predictor_masked=steps, corrector_epilogue=steps,
                    radiation_refreshes=refreshes)
        if counts != want:
            bad.append(f"{label}: counts {counts}, expected {want}")
    elif launched or counts["radiation_refreshes"] != refreshes:
        bad.append(f"{label}: counts {counts} on the plain path")
    return out, counts


def climate_gates(dev, card: str, bad: list) -> dict:
    """Phase 15 (a): the closure gate on both backends, the equilibrium
    gate and the fine-grid gate on the kernel path, each at the reference's
    config and thresholds. Returns {gate: counts of its kernel-path run}."""
    counts = {}
    chunks, steps = CLOSURE_RUN
    for backend in ("pallas", "jnp"):
        cfg = climate_config("closure", backend)
        label = f"closure 96x48x8, backend={backend}"
        (recs, _, grid, _), c = counted(
            label, cfg, chunks * steps,
            lambda: chunk_records(cfg, chunks, steps, dev), card, bad)
        cl = closure_residuals(recs, area_total(grid, cfg.grid.nx))
        fails = closure_failures(cl)
        print(f"  {label}: residuals (W/m2) "
              f"{[round(r, 3) for r in cl['resid']]}, mean {cl['mean']:.3f} "
              f"(< {CLOSURE_BOUNDS['mean']}), max |{cl['max_abs']:.3f}| "
              f"(< {CLOSURE_BOUNDS['resid']}); water change "
              f"{cl['dwater']:.5e} kg against integrated evaporation "
              f"{cl['evap_int']:.5e}: {100 * cl['water_err']:.3f} % (< "
              f"{100 * CLOSURE_BOUNDS['water']:.0f} %)", flush=True)
        bad += [f"{label}: {x}" for x in fails]
        if backend == "pallas":
            counts["closure"] = c

    cfg = climate_config("equilibrium")
    chunks, days = EQUILIBRIUM_RUN
    _, _, g0 = initialize(cfg, device=dev)
    steps = int(days * 86400.0 / float(g0.dt))
    label = "equilibrium 60x30x10"
    (recs, *_), counts["equilibrium"] = counted(
        label, cfg, chunks * steps,
        lambda: chunk_records(cfg, chunks, steps, dev), card, bad)
    rd, fails = equilibrium_verdict(recs[1:])
    print(f"  {label}, {chunks} chunks of {steps} steps at dt "
          f"{float(g0.dt):.3f} s to day {recs[-1]['t_days']:.2f}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in rd.items())
          + f"; bounds {EQUILIBRIUM_BOUNDS}", flush=True)
    bad += [f"{label}: {x}" for x in fails]

    cfg = climate_config("fine grid")
    n, chunk, limit = FINE_RUN
    label = "fine grid 180x90x16"
    out, counts["fine grid"] = counted(
        label, cfg, n, lambda: probe_stability(
            cfg, steps=n, chunk=chunk, wind_limit=limit, verbose=False,
            device=dev), card, bad)
    peak = max(max(r["max_u"], r["max_v"]) for r in out["trajectory"])
    print(f"  {label}: stable {out['stable']}, {out['steps_run']} steps, "
          f"peak wind {peak:.3f} m/s (limit {limit}), POTT "
          f"[{out['trajectory'][-1]['pott_min']:.2f}, "
          f"{out['trajectory'][-1]['pott_max']:.2f}] K at the end", flush=True)
    if not out["stable"]:
        bad.append(f"{label}: blew up at step {out['blowup_step']}")
    return counts


def epilogue_fp32_error(ci, got) -> dict:
    """max|got - the plain epilogue corrector in fp64| of each EPI_TOL
    field, ``got`` the plain version's fp32 answer on ``epilogue_args(ci)``
    and the fp64 one from the same values: the fp32 rounding of the
    computation itself."""
    ev, base, _, _, _ = epilogue_args(ci)
    cfg64 = ci.cfg.replace(dtype="float64")
    _, f64, g64 = initialize(cfg64, device=ci.state.device)

    def wide(s):
        return s.replace(**{f: getattr(s, f).double()
                            for f in STATE_FIELDS + ("t",)})
    want = fs.fused_substep_plain(wide(ev), wide(base), g64, f64, g64.dt,
                                  phys=ci.phys, vmask=ci.vmask.double(),
                                  **ci.kw)
    return {f: float((getattr(got, f).double() - getattr(want, f))
                     .abs().max()) for f in EPI_TOL}


def check_climate_kernels(gate: str, card: str, dev, bad: list):
    """Phase 15 (b): the masked predictor and the epilogue corrector at the
    gate's shape against their plain versions, from its state 10 plain steps
    in (the predictor; also with grid-scale noise) and the same with
    moisture near saturation (the epilogue corrector), within FIELD_TOL and
    the epilogue's bounds at the shape (each field's EPI_TOL, or
    FP32_ERROR_FACTOR times the plain version's own fp32 error against
    fp64 there, the larger); the predictor without the radiative source,
    the predictor
    without diffusion on the noisy state, and the epilogue without each of
    EPI_FAULTS must each break a bound. Then both timed. Returns (errors,
    the epilogue's bounds, timing)."""
    ci = check_inputs(dev, climate_config(gate))
    g, f, dt, kw, vm = ci.grid, ci.forcing, ci.grid.dt, ci.kw, ci.vmask
    shape = "x".join(map(str, CLIMATE_GATES[gate][0]))

    def pred(s, kernel, **over):
        k = dict(kw, vmask=vm, **over)
        return (fs.predictor(s, g, f, dt, **k) if kernel
                else fs.fused_substep_plain(s, None, g, f, dt, **k))

    errs = {}
    for state_name, s in (("state", ci.state), ("noisy state", ci.rough)):
        want = pred(s, False)
        per = field_errors(pred(s, True), want, FIELD_TOL)
        errs["predictor_masked"] = {
            k: max(e, errs.get("predictor_masked", {}).get(k, 0.0))
            for k, e in per.items()}
        print(f"  {shape} {state_name}, predictor (mask) max|kernel-plain|: "
              + show(per, FIELD_TOL), flush=True)
        bad += [f"{shape} masked predictor on the {state_name}: {x} over "
                "its bound" for x in over(per, FIELD_TOL)]
        fault = "with_rad=False" if s is ci.state else "with_diff=False"
        per = field_errors(pred(s, True, **PLANTED_FAULTS[fault]), want,
                           FIELD_TOL)
        print(f"  {shape} {state_name}, planted fault predictor {fault}: "
              + show(per, FIELD_TOL), flush=True)
        if not over(per, FIELD_TOL):
            bad.append(f"{shape}: predictor with {fault} stays within every "
                       "bound")
    kern, plain = epilogue_pair(ci)
    want = plain()
    e64 = epilogue_fp32_error(ci, want)
    tol = {f: max(EPI_TOL[f], FP32_ERROR_FACTOR * e) for f, e in e64.items()}
    print(f"  {shape} moist state, plain corrector+epilogue in fp32 against "
          "fp64 from the same inputs (its own rounding): " + ", ".join(
              f"{f} {e:.3e}" for f, e in e64.items()), flush=True)
    errs["corrector_epilogue"] = field_errors(kern(), want, tol)
    print(f"  {shape} moist state, corrector+epilogue (mask) "
          "max|kernel-plain|: " + show(errs["corrector_epilogue"], tol),
          flush=True)
    bad += [f"{shape} epilogue corrector: {x} over its bound"
            for x in over(errs["corrector_epilogue"], tol)]
    for term in EPI_FAULTS:
        kf = epilogue_pair(ci, phys=phys_with(ci.cfg, **{term: False}))[0]
        per = field_errors(kf(), want, tol)
        print(f"  {shape} planted fault epilogue without {term}: "
              + show(per, tol), flush=True)
        if not over(per, tol):
            bad.append(f"{shape}: epilogue without {term} stays within "
                       "every bound")
    ev, base = epilogue_args(ci)[:2]
    st = ci.state
    timing = {
        "predictor_masked": kernel_timing(
            f"predictor_masked at {tuple(st.u.shape)}",
            lambda: pred(st, True), lambda: pred(st, False),
            substep_bound_ms(st, None, g, f, pred(st, True), vmask=vm),
            card, shape=tuple(st.u.shape)),
        "corrector_epilogue": kernel_timing(
            f"corrector_epilogue at {tuple(st.u.shape)}", kern, plain,
            substep_bound_ms(ev, base, g, f, kern(), phys=ci.phys,
                             vmask=vm), card, shape=tuple(st.u.shape))}
    return errs, tol, timing


def milestone2_checks(s0, out, grid) -> list:
    """The milestone-2 invariants (test_milestone2_fullsize.py:44-52) of
    the state ``out`` run from ``s0``: [(holds, what)]."""
    area = grid.area.double()[:, None]
    m0 = float((s0.colp.double() * area).sum())
    m1 = float((out.colp.double() * area).sum())
    wind = max(float(out.u.abs().max()), float(out.v.abs().max()))
    lo, hi = M2_BOUNDS["pott"]
    pott_lo, pott_hi = float(out.pott.min()), float(out.pott.max())
    q_lo = min(float(out.qv.min()), float(out.qc.min()))
    return [
        (bool(torch.isfinite(out.pott).all()), "POTT finite"),
        (wind < M2_BOUNDS["wind"],
         f"max wind {wind:.3f} < {M2_BOUNDS['wind']} m/s"),
        (abs(m1 - m0) / m0 < M2_BOUNDS["mass"],
         f"dry-mass drift {abs(m1 - m0) / m0:.3e} < {M2_BOUNDS['mass']}"),
        (q_lo >= 0.0, f"least qv, qc {q_lo:.3e} >= 0"),
        (lo < pott_lo and pott_hi < hi,
         f"POTT [{pott_lo:.2f}, {pott_hi:.2f}] inside ({lo}, {hi})")]


def milestone2(dev, card: str, bad: list):
    """Phase 15 (c): BASELINE #2 for M2_STEPS steps on its plain backend,
    counted, and the milestone-2 invariants."""
    cfg = baseline_config(2)
    s0, f0, g0 = initialize(cfg, device=dev)
    label = f"#2 ({cfg.grid.nx}x{cfg.grid.ny}x{cfg.grid.nz}), backend=" \
        f"{cfg.backend}"
    out, _ = counted(label, cfg, M2_STEPS, lambda: model.make_run_fn(
        cfg, M2_STEPS, donate=False)(s0, g0, f0), card, bad)
    for ok, what in milestone2_checks(s0, out, g0):
        print(f"  {'ok ' if ok else 'BAD'} {label}: {what}", flush=True)
        if not ok:
            bad.append(f"{label}: {what}")


def continents_run(dev, card: str, bad: list) -> dict:
    """Phase 15 (d): BASELINE #3 over the continents for 30 days through
    the run command, counted; its sanity checks with the continents'
    ranges; the record at step 632 against the reference's first line, the
    days 20-30 window against CONT_WINDOW_BANDS, and the closure gate over
    all its records. Returns its counts."""
    cfg, res, counts, steady = run_argv(CONT_ARGV, dev)
    every = cfg.physics.rad_every_steps
    want = collections.Counter()
    want.update(predictor_masked=res.steps, corrector_epilogue=res.steps,
                radiation_refreshes=sum(1 for k in range(res.steps)
                                        if k % every == 0))
    print(f"  30 days over the continents: {res.path}; {res.steps} steps in "
          f"{len(res.chunks)} chunks, dt {sorted(set(res.dts))}, "
          f"{1e3 * res.wall_s / res.steps:.3f} ms/step, after the first "
          f"chunk {steady:.3f} ms/step, wall {res.wall_s:.1f} s; counts "
          f"{({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    if counts != want:
        bad.append(f"continents: counts {counts}, expected {want}")
    s0, _, _ = initialize(cfg, device=dev)
    sanity(res.state, res.grid, s0, CONT_MEAN_COLP, CONT_POTT_RANGE)
    recs = res.records
    first = next((r for r in recs if r["step"] == CONT_FIRST_LINE["step"]),
                 None)
    if first is None:
        bad.append(f"continents: no record at step {CONT_FIRST_LINE['step']}")
    else:
        print("  record at step 632 / the reference's first line: " + ", ".join(
            f"{k} {first[k]!r} / {v!r} (within {CONT_FIRST_TOL[k]:.4g})"
            for k, v in CONT_FIRST_LINE.items() if k != "step"), flush=True)
        bad += [f"continents step 632: {k} {first[k]!r} not within "
                f"{CONT_FIRST_TOL[k]} of the reference's {v!r}"
                for k, v in CONT_FIRST_LINE.items()
                if k != "step" and not abs(first[k] - v) <= CONT_FIRST_TOL[k]]
    wf = window_figures(recs, CONT_WINDOW_STEPS)
    print(f"  days 20-30 ({wf['records']} records, steps "
          f"{CONT_WINDOW_STEPS}): " + ", ".join(
              f"{k} {wf[k]!r} in {CONT_WINDOW_BANDS[k]}"
              for k in CONT_WINDOW_BANDS), flush=True)
    bad += [f"continents days 20-30: {x}"
            for x in band_failures(wf, CONT_WINDOW_BANDS)]
    cl = closure_residuals(recs, area_total(res.grid, cfg.grid.nx))
    print(f"  closure over {len(recs) - 1} chunks to day "
          f"{recs[-1]['t_days']:.4f}: mean residual {cl['mean']:.3f} W/m2, "
          f"max |{cl['max_abs']:.3f}|; water {100 * cl['water_err']:.3f} % "
          f"(the reference over its first 30 days: 1.020, |6.432|, 1.006 %)",
          flush=True)
    bad += [f"continents: {x}" for x in closure_failures(cl)]
    return counts


def climate_path(dev, card: str) -> dict:
    """Phase 15: (a) the climate gates, (b) the two kernels of the path at
    the gates' shapes, (c) milestone #2, (d) 30 days over the continents.
    Returns the counts of (a), the errors, bounds and timing of (b) and
    (d)'s counts."""
    bad = []
    counts = climate_gates(dev, card, bad)
    errs, tols, timing = {}, {}, {}
    for gate in CLIMATE_GATES:
        errs[gate], tols[gate], timing[gate] = check_climate_kernels(
            gate, card, dev, bad)
    milestone2(dev, card, bad)
    cont = continents_run(dev, card, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(counts=counts, errs=errs, tols=tols, timing=timing,
                continents=cont)


# ---------------------------------------------------------------------------
# Phase 16 (across cards): only with --multicard, on four cards
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 17: the compiled chunk
# ---------------------------------------------------------------------------

COMPILED_CHUNK = 100             # steps a chunk of the #3 run
COMPILED_HORIZON = 3.5           # its horizon, in chunks at the preset dt
# each chunk's adaptive dt is scaled by this once more than the last's: at
# #3 the wind stays under adaptive_cfl_dt's 100 m/s floor, so its dt
# would not change
COMPILED_DT_SCALE = 0.97
COMPILED_CASES = (("#4 on 2x4, halo overlap", SHARDED_ARGV),
                  ("#4 on 2x4, blocking", BLOCKING_ARGV),
                  ("#5 unsharded", B5_UNSHARDED_ARGV),
                  ("#5 on 4x8, halo overlap", B5_OVERLAP_ARGV),
                  ("#5 on 4x8, blocking", B5_ARGV))
COMPILED_FAULTS = ("replays keep the capture-time dt",
                   "the same parity replayed twice")
# the short names of the kernels in a profile
KERNEL_SHORT = (("substep_kernel<true>", "substep(predictor)"),
                ("substep_kernel<false>", "substep(corrector)"),
                ("epilogue_kernel", "epilogue")) \
    + tuple((f"rk4_stage_kernel<{m}>", f"rk4 stage {m}")
            for m in (1, 2, 3, 4))


def compiled_config(dev):
    """#3 (``run --baseline 3``) in chunks of COMPILED_CHUNK steps over
    COMPILED_HORIZON chunks: with radiation every 105 steps each chunk
    meets the refresh at a different step."""
    cfg = cli.build_config(cli.make_parser().parse_args(
        ["run", "--baseline", "3"]))
    dt0 = initialize(cfg, device=dev)[2].dt
    return cfg.replace(
        out_every_hours=(COMPILED_CHUNK + 0.5) * dt0 / 3600.0,
        sim_days=COMPILED_HORIZON * COMPILED_CHUNK * dt0 / 86400.0)


def scaled_dt(real):
    """``adaptive_cfl_dt`` with the dt after the k-th chunk scaled by
    COMPILED_DT_SCALE ** k. The chunk loop asks at the run's wind; the grid
    (``make_grid``, also when the radiation interval is resolved) asks at
    the 100 m/s floor, and keeps its dt."""
    calls = [0]

    def dt(min_dx, cfl, max_wind):
        if max_wind >= 100.0:
            return real(min_dx, cfl, max_wind)
        calls[0] += 1
        return real(min_dx, cfl, max_wind) * COMPILED_DT_SCALE ** calls[0]
    return dt


def compiled_run(cfg, dev, graphs, dt_change=False):
    """``cli.run`` of ``cfg``, eager (``graphs=False``) or compiled, with
    every counter set to 0 just before and read just after; with
    ``dt_change`` every chunk's dt COMPILED_DT_SCALE times the last's.
    Returns (result, counts, steady ms/step, graphs captured,
    peak_memory)."""
    from climate_model_tpu_torch import graphs as cg
    from climate_model_tpu_torch.core import grid as cgrid
    reset_counts()
    c0 = cg.captures
    schedule = dict(adaptive_cfl_dt=scaled_dt(cgrid.adaptive_cfl_dt)) \
        if dt_change else {}
    with peak_memory(dev) as peak, planted(cgrid, **schedule):
        res = cli.run(cfg, device=dev, graphs=graphs)
    counts = read_counts()
    if res.aborted:
        raise AssertionError("the run aborted on a non-finite state")
    steady = 1e3 * sum(r["wall_s"] for r in res.records[1:]) \
        / max(sum(res.chunks[1:]), 1)
    return res, counts, steady, cg.captures - c0, peak


def same_run(a, b) -> bool:
    """Two runs' final states equal bit for bit, ``t`` included."""
    return bitwise_equal(a.state, b.state, STATE_FIELDS) and torch.equal(
        a.state.t.reshape(1).view(torch.uint8),
        b.state.t.reshape(1).view(torch.uint8))


def profiled_kernels(fn, n: int) -> tuple:
    """Device time per call of ``fn`` from ``torch.profiler``'s trace over
    ``n`` calls: ({(kernel, grid): (launches a call, ms a launch)}, busy
    ms a call summed over every kernel and copy), or (None, None) where the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    by, busy = {}, 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in ("kernel",
                                                        "gpu_memcpy",
                                                        "gpu_memset"):
            continue
        busy += ev.get("dur", 0.0)
        if ev["cat"] != "kernel":
            continue
        name = next((s for k, s in KERNEL_SHORT if k in ev.get("name", "")),
                    None)
        if name is None:
            continue
        key = (name, tuple(ev.get("args", {}).get("grid", ())))
        c, us = by.get(key, (0, 0.0))
        by[key] = (c + 1, us + ev.get("dur", 0.0))
    if not busy:
        return None, None
    return ({k: (c / n, us / c / 1e3) for k, (c, us) in by.items()},
            busy / n / 1e3)


def show_kernels(by) -> str:
    if by is None:
        return "not measured (the trace holds no device time)"
    return "; ".join(f"{name} grid {list(grid)}: {c:g} a step x "
                     f"{ms:.4f} ms" for (name, grid), (c, ms)
                     in sorted(by.items()))


def step_readings(cfg, res, dev, graphs: bool) -> dict:
    """One more chunk of COMPILED_CHUNK steps from the run's final state,
    twice: ms/step (synchronized) and the host's ms/step to enqueue it;
    then the same chunk profiled, for the device's busy ms a step (every
    kernel and copy summed, the chunk's copies in and out too) and each
    kernel's; idle share = 1 - busy / ms."""
    runn = make_chunk_runner(cfg, COMPILED_CHUNK, graphs=graphs)
    s, g, f = res.state, res.grid, res.forcing
    if isinstance(s, State) and cfg.sharding.mesh_lat \
            * cfg.sharding.mesh_lon > 1:
        s = sharding.shard(make_mesh(cfg, device=dev), s, g, f)
    runn(s, g, f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runn(s, g, f)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by, busy = profiled_kernels(lambda: runn(s, g, f), 1)
    ms = 1e3 * wall / COMPILED_CHUNK
    if by is not None:
        busy /= COMPILED_CHUNK
        by = {k: (c / COMPILED_CHUNK, t) for k, (c, t) in by.items()}
    return dict(ms=ms, host_ms=1e3 * host / COMPILED_CHUNK, busy_ms=busy,
                idle=None if busy is None else 1.0 - busy / ms,
                kernels=by)


def show_readings(name: str, r: dict) -> str:
    idle = "not measured" if r["idle"] is None else f"{r['idle']:.3f}"
    busy = "not measured" if r["busy_ms"] is None \
        else f"{r['busy_ms']:.4f}"
    return (f"{name} {r['ms']:.4f} ms/step, host enqueue "
            f"{r['host_ms']:.4f} ms/step, device busy {busy} ms/step, idle "
            f"share {idle}")


def capture_line(dev) -> str:
    """What the most recent runner's captures took."""
    from climate_model_tpu_torch import graphs as cg
    r = cg.cached_runners()[-1]
    pool = "not measured" if r.pool_bytes is None \
        else f"{r.pool_bytes / 1e9:.3f} GB"
    return (f"{len(r.graphs)} graphs captured in {r.capture_s:.3f} s, pool "
            f"{pool}")


def compiled_b3(dev, card: str, bad: list) -> dict:
    """#3 through ``cli.run``, eager and compiled in turns; counted, bit for
    bit, no capture after the first chunk; the planted faults; the step's
    readings."""
    from climate_model_tpu_torch import graphs as cg
    cfg = compiled_config(dev)
    runs = {}
    for turn, graphs in enumerate((False, None, None, False)):
        if graphs is None:
            cg.clear_cache()
        res, counts, steady, caps, peak = compiled_run(cfg, dev, graphs,
                                                       dt_change=True)
        name = "eager" if graphs is False else "graphs"
        runs.setdefault(name, []).append((res, counts, steady, caps, peak))
        print(f"  #3 turn {turn + 1} {name}: {res.steps} steps {res.chunks}, "
              f"dt {res.dts}, after the first chunk {steady:.4f} ms/step; "
              f"{caps} graphs captured; {peak}"
              + (f"; {capture_line(dev)}" if name == "graphs" else "")
              + f" [{card}]", flush=True)
    ref, ref_counts = runs["eager"][0][0], runs["eager"][0][1]
    if len(ref.chunks) < 3 or len(set(ref.dts)) < 2:
        bad.append(f"#3: chunks {ref.chunks}, dts {ref.dts}: expected 3 "
                   "chunks or more and a dt change")
    every = cfg.physics.rad_every_steps
    phases = [-(-sum(ref.chunks[:i]) // every) * every - sum(ref.chunks[:i])
              for i in range(len(ref.chunks))]
    print(f"  #3: radiation every {every} steps, the first refresh after "
          f"each chunk's start at its step {phases}", flush=True)
    for name, items in runs.items():
        for res, counts, _, caps, _ in items:
            if not same_run(res, ref):
                bad.append(f"#3 {name} run differs from the eager run")
            if counts != ref_counts:
                bad.append(f"#3 {name}: counts {counts} != eager "
                           f"{ref_counts}")
            if name == "graphs" and caps != 4:
                bad.append(f"#3: {caps} graphs captured over {res.chunks}, "
                           "expected 4 (one per parity and radiation "
                           "variant, none after a dt change)")
    print(f"  #3 compiled vs eager: bitwise equal "
          f"{all(same_run(r[0], ref) for r in runs['graphs'])}; counts "
          f"{({k: v for k, v in ref_counts.items() if v})}", flush=True)
    real_set = fs.StepScalars.set
    real_replay = cg._Captured.replay
    faults = {COMPILED_FAULTS[0]: (fs.StepScalars, dict(
                  set=lambda self, dt: real_set(self, dt) if self.dt is None
                  else False)),
              COMPILED_FAULTS[1]: (cg._Captured, dict(
                  replay=lambda self, key: real_replay(self, (0, key[1]))))}
    for fault, (owner, attrs) in faults.items():
        cg.clear_cache()
        with planted(owner, **attrs):
            res, _, _, _, _ = compiled_run(cfg, dev, None, dt_change=True)
        cg.clear_cache()
        per = state_diffs(res.state, ref.state)
        broke = not same_run(res, ref)
        print(f"  #3 planted fault: {fault}; bitwise equal {not broke}; "
              + ", ".join(f"{k} {v:.3e}" for k, v in per.items() if v),
              flush=True)
        if not broke:
            bad.append(f"#3: the fault '{fault}' left the run bit for bit")
    cg.clear_cache()
    eager = step_readings(cfg, ref, dev, False)
    res_g = runs["graphs"][0][0]
    graph = step_readings(cfg, res_g, dev, None)
    print("  #3 one more chunk from each run's end: "
          + show_readings("eager", eager) + "; "
          + show_readings("compiled", graph) + f" [{card}]", flush=True)
    print(f"  #3 captured step, device time a step by kernel: "
          f"{show_kernels(graph['kernels'])} [{card}]", flush=True)
    return dict(b3=dict(eager=eager, graphs=graph,
                        steady=[(n, r[2]) for n, items in runs.items()
                                for r in items]))


def compiled_case(name, argv, dev, card: str, bad: list) -> dict:
    """``argv`` through ``cli.run``, eager then compiled: counted, bit for
    bit, four captures; ms/step of each and the step's readings."""
    from climate_model_tpu_torch import graphs as cg
    cfg = cli.build_config(cli.make_parser().parse_args(argv))
    out = {}
    for label, graphs in (("eager", False), ("graphs", None)):
        cg.clear_cache()
        out[label] = compiled_run(cfg, dev, graphs)
    (a, ca, ma, _, pa), (b, cb, mb, caps, pb) = out["eager"], out["graphs"]
    equal = same_run(a, b)
    cap = capture_line(dev)
    print(f"  {name}: {b.steps} steps {b.chunks}; after the first chunk "
          f"eager {ma:.4f}, compiled {mb:.4f} ms/step; {cap}; eager {pa}, "
          f"compiled {pb}; bitwise equal {equal} [{card}]", flush=True)
    if not equal:
        bad.append(f"{name}: the compiled run differs from the eager run")
    if ca != cb:
        bad.append(f"{name}: counts {cb} != eager {ca}")
    if caps != 4:
        bad.append(f"{name}: {caps} graphs captured, expected 4")
    if a.dts != b.dts:
        bad.append(f"{name}: dts {b.dts} != eager {a.dts}")
    graph = step_readings(cfg, b, dev, None)
    print(f"  {name} one more chunk: " + show_readings("compiled", graph)
          + f"; captured step by kernel: {show_kernels(graph['kernels'])} "
          f"[{card}]", flush=True)
    cg.clear_cache()
    return dict(eager_ms=ma, graphs_ms=mb, readings=graph)


def compiled_path(dev, card: str) -> dict:
    """Phase 17: the compiled chunk against the eager loop."""
    bad = []
    out = compiled_b3(dev, card, bad)
    for name, argv in COMPILED_CASES:
        out[name] = compiled_case(name, argv, dev, card, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return out


ROOT = os.path.dirname(os.path.abspath(__file__))
MC_WORLD = 4                     # ranks, one card each; every mesh has 4
# seconds a torchrun launch may take before its whole session is killed:
# a hung NCCL call fails the phase instead of stalling it
MC_TIMEOUT_S = {"run": 180, "worker": 420}
# (a) BASELINE #4 on 2x2, one shard per card, through the run command under
# torchrun, phase 8's horizon (258 steps in three chunks) with its files:
# with halo overlap, then blocking
MC_B4_ARGV = ["run", "--baseline", "4", "--mesh-lat", "2", "--mesh-lon",
              "2", "--days", "0.05", "--out-every-hours", "0.4"]
MC_CLI_RUNS = (("b4_2x2_overlap", MC_B4_ARGV + ["--halo-overlap"]),
               ("b4_2x2_blocking", MC_B4_ARGV))
# (c)'s horizon at #4: 50 steps at 16.715 s, in two chunks of 25
MC_B4_50_ARGV = ["run", "--baseline", "4", "--days", "0.00967",
                 "--out-every-hours", "0.12"]


# Phase 18 (rk4). Per-field bounds on max|kernel - plain| for ONE stage at
# config #3 in fp32, from the plain RK4 chain's inputs (the moist check
# state, moist_state, so that qv and qc move): the next stage state, and the
# accumulator (w dt k, the conserved tendencies' units: Pa m/s for u and v,
# Pa K for pott, Pa for colp, Pa kg/kg for qv and qc). RK4_STEP_TOL bounds
# the four stages chained against the plain step's dynamics (``step_rk4``).
# Each is 3.1-3.9x the largest error an H100 read over the four stages
# (state: u 1.25e-4 m/s, v 3.24e-5 m/s, pott 6.1e-5 K, qv 9.3e-10, qc
# 1.16e-10, colp 7.8e-3 Pa; accumulator: u 3.80, v 0.99, pott 2.79e-3, qv
# 4.8e-7, qc 8.9e-8, colp 1.02e-6; chained: u 7.8e-5, v 2.2e-5, pott
# 6.1e-5, qv 1.9e-9, qc 1.16e-10, colp 7.8e-3). A planted fault has to
# break a bound after the stage it is planted in or after the step.
RK4_TOL = {"u": 4e-4, "v": 1e-4, "pott": 2e-4, "qv": 3e-9, "qc": 4e-10,
           "colp": 0.03}
RK4_ACC_TOL = {"u": 12.0, "v": 3.5, "pott": 1e-2, "qv": 1.5e-6,
               "qc": 3e-7, "colp": 4e-6}
RK4_STEP_TOL = {"u": 3e-4, "v": 7e-5, "pott": 2e-4, "qv": 6e-9,
                "qc": 4e-10, "colp": 0.03}
RK4_FAULTS = ("k2 weighted 1 in place of 2",
              "COLP_new from the stage state in place of the t_n state")
RK4_REPLACES = "climate_model_tpu/dycore/stepper.py:42 (step_rk4, plain)"
RK4_PHASE_MSG = ("each RK4 stage kind agrees with its plain version at #3 "
                 "fp32, chained with the plain step; each planted fault "
                 "breaks a bound; #3 RK4 compiled equals eager bit for bit, "
                 "counted alike")


def rk4_counts() -> dict:
    return {k: v for k, v in read_counts().items() if v}


def acc_view(acc: dict):
    return types.SimpleNamespace(**acc)


def rk4_chain(ci: CheckInputs, stage_fn, mask, fault=None):
    """The four stages of one RK4 step from ``ci.state`` by ``stage_fn``
    (``fs.rk4_stage`` or ``fs.rk4_stage_plain``): the stage states, and the
    accumulator before and after each stage. ``fault`` plants one of
    RK4_FAULTS on the way."""
    g, f, dt, st = ci.grid, ci.forcing, ci.grid.dt, ci.moist
    acc = fs.rk4_accumulator(st)
    states, accs = [st], []
    for m in (1, 2, 3, 4):
        before = {k: v.clone() for k, v in acc.items()}
        y0 = st
        if fault == RK4_FAULTS[1] and m == 2:
            y0 = st.replace(colp=states[-1].colp)
        nxt = stage_fn(states[-1], y0, acc, g, f, dt, stage=m, vmask=mask,
                       **ci.kw)
        if fault == RK4_FAULTS[0] and m == 2:
            for k in acc:
                acc[k] = before[k] + 0.5 * (acc[k] - before[k])
        states.append(nxt)
        accs.append((before, {k: v.clone() for k, v in acc.items()}))
    return states, accs


def rk4_stage_checks(ci: CheckInputs, bad: list) -> dict:
    """Each stage kind on the plain chain's inputs against its plain
    version; the chained stages against the plain step; the planted
    faults."""
    g, f, dt, vm = ci.grid, ci.forcing, ci.grid.dt, ci.vmask
    want, want_acc = rk4_chain(ci, fs.rk4_stage_plain, vm)
    errs = {}
    for m in (1, 2, 3, 4):
        for mask in (vm, None):
            acc = {k: v.clone() for k, v in want_acc[m - 1][0].items()}
            got = fs.rk4_stage(want[m - 1], ci.moist, acc, g, f, dt,
                               stage=m, vmask=mask, **ci.kw)
            if mask is None:
                same = bitwise_equal(got, masked) and all(
                    torch.equal(acc[k].view(torch.int32),
                                acc_m[k].view(torch.int32)) for k in acc)
                if not same:
                    bad.append(f"rk4 stage {m}: the mask differs from the "
                               "index rule")
                continue
            masked, acc_m = got, acc
            e = field_errors(got, want[m], RK4_TOL)
            ea = field_errors(acc_view(acc), acc_view(want_acc[m - 1][1]),
                              RK4_ACC_TOL) if m < 4 else {}
            errs[f"rk4_stage{m}"] = e
            print(f"  rk4 stage {m} max|kernel-plain|: state "
                  + show(e, RK4_TOL)
                  + (f"; accumulator {show(ea, RK4_ACC_TOL)}" if ea else ""),
                  flush=True)
            bad += [f"rk4 stage {m}: {x} over its bound"
                    for x in over(e, RK4_TOL)]
            bad += [f"rk4 stage {m}: accumulator {x} over its bound"
                    for x in over(ea, RK4_ACC_TOL)]
    print("  rk4 stages: the single-device mask equals the index rule bit "
          "for bit", flush=True)
    # the epilogue alone, after the last stage, on the plain stage 4 state
    got = fs.epilogue(want[4], g, f, dt, phys=ci.phys, vmask=vm)
    errs["rk4_epilogue"] = field_errors(
        got, fs.epilogue_plain(want[4], g, f, dt, phys=ci.phys, vmask=vm),
        EPI_TOL)
    print("  rk4 epilogue alone max|kernel-plain|: "
          + show(errs["rk4_epilogue"], EPI_TOL), flush=True)
    bad += [f"rk4 epilogue: {x} over its bound"
            for x in over(errs["rk4_epilogue"], EPI_TOL)]
    plain_step = stepper_rk4(ci.moist, g, f, ci.cfg)
    e = field_errors(want[4], plain_step, RK4_STEP_TOL)
    print("  rk4 plain stages chained vs plain step_rk4 (fp32): "
          + show(e, RK4_STEP_TOL), flush=True)
    got, _ = rk4_chain(ci, fs.rk4_stage, vm)
    errs["rk4_step"] = field_errors(got[4], plain_step, RK4_STEP_TOL)
    print("  rk4 kernel stages chained vs plain step_rk4: "
          + show(errs["rk4_step"], RK4_STEP_TOL), flush=True)
    bad += [f"rk4 chained stages: {x} over its bound"
            for x in over(errs["rk4_step"], RK4_STEP_TOL)]
    for fault in RK4_FAULTS:
        got, got_acc = rk4_chain(ci, fs.rk4_stage, vm, fault=fault)
        per = field_errors(got[4], plain_step, RK4_STEP_TOL)
        one = field_errors(got[2], want[2], RK4_TOL)
        one_acc = field_errors(acc_view(got_acc[1][1]),
                               acc_view(want_acc[1][1]), RK4_ACC_TOL)
        print(f"  planted fault {fault}: after stage 2 state "
              f"{show(one, RK4_TOL)}; accumulator "
              f"{show(one_acc, RK4_ACC_TOL)}; after the step "
              f"{show(per, RK4_STEP_TOL)}", flush=True)
        if not (over(one, RK4_TOL) or over(one_acc, RK4_ACC_TOL)
                or over(per, RK4_STEP_TOL)):
            bad.append(f"rk4 with '{fault}' stays within every bound")
    return errs


def epilogue_bound_ms(state, forcing, out, vmask) -> tuple:
    """(ms, what bounds it): the least time of the epilogue alone, each
    tensor it reads counted once and each it writes once, at the card's
    peaks."""
    reads = [getattr(state, f) for f in ("u", "v", "pott", "qv", "qc",
                                         "colp", "tsurf", "rain",
                                         "soil_moist", "swflx_sfc",
                                         "lwflx_sfc")]
    reads += [forcing.land_mask, forcing.evap_eff, vmask]
    writes = [getattr(out, f) for f in ("u", "v", "pott", "qv", "qc",
                                        "tsurf", "rain", "soil_moist")]
    n_bytes = sum(t.numel() * t.element_size() for t in reads + writes)
    return bound_ms(n_bytes, EPILOGUE_FLOPS_PER_POINT * state.u.numel(),
                    state.u.device)


def time_rk4(ci: CheckInputs, card: str) -> dict:
    """Each stage kind and the epilogue alone against its plain version,
    in turns, on the plain chain's inputs, beside its bound: a stage's
    bytes and operations as ``benchmark/reference_rk4/counts.py`` counts
    them (the yardstick of ``roofline_pct.rk4_stage``), the epilogue's by
    ``epilogue_bound_ms``. The stages' calls keep adding into a copy of
    the accumulator, which changes no stage's work."""
    from benchmark.reference_rk4 import counts as rk4_work
    g, f, dt, vm = ci.grid, ci.forcing, ci.grid.dt, ci.vmask
    want, want_acc = rk4_chain(ci, fs.rk4_stage_plain, vm)
    nz, ny, nx = ci.moist.u.shape
    timing = {}
    for m in (1, 2, 3, 4):
        acc = {k: v.clone() for k, v in want_acc[m - 1][0].items()}
        args = (want[m - 1], ci.moist, acc, g, f, dt)
        kw = dict(stage=m, vmask=vm, **ci.kw)
        bound = bound_ms(rk4_work.stage_bytes(m, nx, ny, nz),
                         rk4_work.stage_flops(nx, ny, nz), ci.moist.u.device)
        timing[f"rk4_stage{m}"] = kernel_timing(
            f"rk4 stage {m}",
            lambda args=args, kw=kw: fs.rk4_stage(*args, **kw),
            lambda args=args, kw=kw: fs.rk4_stage_plain(*args, **kw),
            bound, card)
    s4, ekw = want[4], dict(phys=ci.phys, vmask=vm)
    timing["rk4_epilogue"] = kernel_timing(
        "rk4 epilogue alone",
        lambda: fs.epilogue(s4, g, f, dt, **ekw),
        lambda: fs.epilogue_plain(s4, g, f, dt, **ekw),
        epilogue_bound_ms(s4, f, fs.epilogue(s4, g, f, dt, **ekw), vm),
        card)
    return timing


def stepper_rk4(state, grid, forcing, cfg):
    from climate_model_tpu_torch.dycore.stepper import step_rk4
    return step_rk4(state, grid, forcing,
                    cfg.replace(numerics=dataclasses.replace(
                        cfg.numerics, time_stepping="rk4")))


def rk4_compiled(dev, card: str, bad: list) -> dict:
    """#3 with RK4 through ``cli.run``, eager and compiled in turns."""
    from climate_model_tpu_torch import graphs as cg
    base = compiled_config(dev)
    cfg = base.replace(numerics=dataclasses.replace(base.numerics,
                                                    time_stepping="rk4"))
    runs = {}
    for turn, graphs in enumerate((False, None, None, False)):
        if graphs is None:
            cg.clear_cache()
        res, _, steady, caps, peak = compiled_run(cfg, dev, graphs,
                                                  dt_change=True)
        counts = rk4_counts()
        name = "eager" if graphs is False else "graphs"
        runs.setdefault(name, []).append((res, counts, steady, caps))
        print(f"  #3 rk4 turn {turn + 1} {name}: {res.steps} steps "
              f"{res.chunks}, dt {res.dts}, after the first chunk "
              f"{steady:.4f} ms/step; {caps} graphs captured; {peak}"
              + (f"; {capture_line(dev)}" if name == "graphs" else "")
              + f" [{card}]", flush=True)
    ref, ref_counts = runs["eager"][0][0], runs["eager"][0][1]
    n = ref.steps
    want = {**{f"rk4_stage_k{m}": n for m in (1, 2, 3, 4)}, "epilogue": n,
            "radiation_refreshes": ref_counts.get("radiation_refreshes", 0)}
    if ref_counts != want or len(set(ref.dts)) < 2:
        bad.append(f"#3 rk4: counts {ref_counts}, dts {ref.dts}: expected "
                   f"{want} and a dt change")
    for name, items in runs.items():
        for res, counts, _, caps in items:
            if not same_run(res, ref):
                bad.append(f"#3 rk4 {name} run differs from the eager run")
            if counts != ref_counts:
                bad.append(f"#3 rk4 {name}: counts {counts} != eager "
                           f"{ref_counts}")
            if name == "graphs" and caps != 4:
                bad.append(f"#3 rk4: {caps} graphs captured, expected 4")
    s = ref.state
    wind = float(max(s.u.abs().max(), s.v.abs().max()))
    print(f"  #3 rk4 compiled vs eager: bitwise equal "
          f"{all(same_run(r[0], ref) for r in runs['graphs'])}; counts "
          f"{ref_counts}; max|V| {wind:.2f} m/s, mean COLP "
          f"{float(s.colp.mean()):.1f} Pa", flush=True)
    cg.clear_cache()
    eager = step_readings(cfg, ref, dev, False)
    graph = step_readings(cfg, runs["graphs"][0][0], dev, None)
    print("  #3 rk4 one more chunk from each run's end: "
          + show_readings("eager", eager) + "; "
          + show_readings("compiled", graph) + f" [{card}]", flush=True)
    print(f"  #3 rk4 captured step, device time a step by kernel: "
          f"{show_kernels(graph['kernels'])} [{card}]", flush=True)
    cg.clear_cache()
    return dict(eager=eager, graphs=graph, counts=ref_counts)


def rk4_path(dev, card: str) -> dict:
    """Phase 18."""
    bad = []
    ci = check_inputs(dev)
    errs = rk4_stage_checks(ci, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    timing = time_rk4(ci, card)
    del ci
    readings = rk4_compiled(dev, card, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    return dict(errs=errs, timing=timing, counts=readings["counts"])


HALO_COPY_RANKS = (0, 2)         # #5 on 2x2: a north seam, a south seam
HALO_COPY_SENTINEL = -7.25       # in every destination before a copy
HALO_COPY_REPLACES = ("climate_model_tpu/dist/packed_halo.py:105 "
                      "(refresh_ghosts: ppermute of sliced ghost slabs)")


def halo_copy_config():
    """#5 on 2x2 with halo overlap, as ``bl5_2x2_overlap`` runs it."""
    cfg = baseline_config(5)
    return resolve_rad_interval(cfg.replace(sharding=dataclasses.replace(
        cfg.sharding, mesh_lat=2, mesh_lon=2, halo_overlap=True)))


def halo_copy_batches(cfg, dev, seed: int = SEED) -> dict:
    """rank -> [(name, run, pairs, got)]: the batched slab copies
    (``kernels/halo_copy.py``) of one packed-scan step of ``cfg`` (a mesh
    of more than one lat shard, halo overlap) on each rank of
    HALO_COPY_RANKS, on that rank's block of ``cfg``'s grid with seeded
    noise in every field. ``run()`` is the port's call: ``comm._pack_into``
    and ``comm._unpack`` of the column refresh and the row exchange of the
    12 and of the 6 fields, the seam strip's ``cut`` (three a step) and its
    ``merge`` of the predictor's 6 and the corrector's fields. ``pairs``
    are the (dst, src) slabs it copies, as the per-slab copies take them,
    and ``got()`` what ``run`` wrote, pair by pair."""
    state, forcing, grid = initialize(cfg, device=dev)
    ss = sharding.shard(make_mesh(cfg, device=dev), state, grid, forcing)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def noisy(st):
        return st.replace(**{f: torch.randn(
            getattr(st, f).shape, device=dev, dtype=st.dtype, generator=gen)
            for f in sharding.STATE_FIELDS})

    corr = packed_halo.DYN_FIELDS + (packed_halo.EPI_FIELDS if
                                     phys_epilogue_tuple(cfg) is not None
                                     else ())
    out = {}
    for rank in HALO_COPY_RANKS:
        lay, st = ss.layouts[rank], noisy(ss.states[rank])
        ex = comm.DistExchange(dataclasses.replace(ss.mesh, rank=rank),
                               ss.layouts)
        nb = ex.neighbours(lay)
        side = "north" if lay.gn else "south"
        batches = []
        for k, names in (("12", packed_halo.PROG_FIELDS
                          + packed_halo.RAD_FIELDS),
                         ("6", packed_halo.DYN_FIELDS)):
            xs = [getattr(st, f) for f in names]
            dst = ex._row_dst(lay, side)
            src = ex._row_src(lay, side, dst.stop - dst.start)
            for kind, sends, recvs in (
                    ("cols", [(nb[s], 0, [x[..., ex._col_src(lay, s)]
                                          for x in xs])
                              for s in ex.LON_SENDS],
                     [(nb[s], 0, [x[..., ex._col_dst(lay, s)] for x in xs])
                      for s in ("west", "east")]),
                    ("rows", [(nb[side], 0, [x[..., src, :] for x in xs])],
                     [(nb[side], 0, [x[..., dst, :] for x in xs])])):
                bufs = [torch.randn(sum(t.numel() for t in s), device=dev,
                                    dtype=st.dtype, generator=gen)
                        for _, _, s in sends]
                pack = list(comm._slots(bufs, [s for _, _, s in sends]))
                unpack = [(g, slot) for slot, g in comm._slots(
                    bufs, [g for _, _, g in recvs])]
                batches += [
                    (f"{kind}{k}.pack",
                     lambda b=bufs, s=sends: comm._pack_into(b, s), pack,
                     lambda p=pack: [d for d, _ in p]),
                    (f"{kind}{k}.unpack",
                     lambda b=bufs, r=recvs: comm._unpack(b, r), unpack,
                     lambda p=unpack: [d for d, _ in p])]
        strip = packed_halo.SeamStrip(
            side, lay, ss.grids[rank], ss.forcings[rank],
            packed_halo.row_mask(lay, st.dtype, dev), ss.halo)
        cut = {f: getattr(st, f)[..., strip.r0:strip.r1, :]
               for f in sharding.STATE_FIELDS}
        copied = [f for f, x in cut.items() if not x.is_contiguous()]
        held = {}

        def run_cut(st=st, strip=strip, held=held):
            held["cut"] = strip.cut(st)
        batches.append((
            "cut", run_cut,
            [(torch.empty_like(cut[f], memory_format=torch.contiguous_format),
              cut[f]) for f in copied],
            lambda held=held, c=copied: [getattr(held["cut"], f)
                                         for f in c]))
        strip_out = strip.cut(noisy(ss.states[rank]))
        d0, s0, n = strip.keep
        for k, fields in (("6", packed_halo.DYN_FIELDS), (str(len(corr)),
                                                          corr)):
            pairs = [(getattr(st, f)[..., d0:d0 + n, :],
                      getattr(strip_out, f)[..., s0:s0 + n, :])
                     for f in fields]
            batches.append((
                f"splice{k}",
                lambda strip=strip, st=st, o=strip_out, f=fields:
                strip.merge(st, o, f),
                pairs, lambda p=pairs: [d for d, _ in p]))
        out[rank] = batches
    return out


def halo_copy_step(batches: list) -> list:
    """A rank's step of ``halo_copy_batches``: each batch once, the cut
    three times (the predictor's strip, the corrector's two inputs)."""
    return [b for b in batches for _ in range(3 if b[0] == "cut" else 1)]


def bits_of(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


def slab_pass(run, pairs, got) -> tuple:
    """(bit for bit, counts): ``run`` (the port's batched copy) against the
    per-slab ``copy_`` of ``pairs`` on the same inputs, every destination
    set to HALO_COPY_SENTINEL before each; the port's counters over ``run``
    alone, set to 0 just before it."""
    for d, _ in pairs:
        d.fill_(HALO_COPY_SENTINEL)
    for d, s in pairs:
        d.copy_(s)
    want = [d.clone() for d, _ in pairs]
    for d, _ in pairs:
        d.fill_(HALO_COPY_SENTINEL)
    reset_counts()
    run()
    counts = read_counts()
    have = got()
    ok = len(have) == len(want) and all(
        torch.equal(bits_of(a), bits_of(b)) for a, b in zip(have, want))
    return ok, counts


def halo_copy_extra(dev) -> dict:
    """name -> pairs: float64 slabs, runs misaligned to 16 bytes, and more
    pairs than a launch takes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x64 = torch.randn(4, 50, 333, generator=gen, device=dev,
                      dtype=torch.float64)
    x32 = torch.randn(5, 70, 2053, generator=gen, device=dev)
    return {
        "f64 cols": [(torch.empty(4, 50, 3, device=dev,
                                  dtype=torch.float64), x64[..., 1:4])],
        "f64 rows": [(torch.empty(4, 7, 333, device=dev,
                                  dtype=torch.float64), x64[:, 3:10, :])],
        "misaligned runs": [(torch.empty(5, 70, 2050, device=dev),
                             x32[..., k:k + 2050]) for k in range(4)],
        "many slabs": [(torch.empty(5, 2, 2053, device=dev),
                        x32[:, k:k + 2, :])
                       for k in range(hc.MAX_SLABS + 9)]}


def halo_copy_check(cfg, dev, bad: list) -> dict:
    """Each batch of ``halo_copy_batches`` and of ``halo_copy_extra``
    through ``slab_pass``: bit for bit, and a launch for every MAX_SLABS
    pairs; then each rank's step counted from 0: rank -> (launches,
    slabs), which ``halo_copies`` implies a rank."""
    for name, pairs in halo_copy_extra(dev).items():
        ok, c = slab_pass(lambda p=pairs: hc.copy_slabs(p), pairs,
                          lambda p=pairs: [d for d, _ in p])
        want = (-(-len(pairs) // hc.MAX_SLABS), len(pairs))
        got = (c["halo_copy_launches"], c["halo_copy_slabs"])
        print(f"  {name}: {got[1]} slabs in {got[0]} launch(es), bit for "
              f"bit {ok}", flush=True)
        if not ok or got != want:
            bad.append(f"slab copy {name}: bit for bit {ok}, (launches, "
                       f"slabs) {got}, expected {want}")
    by_rank = halo_copy_batches(cfg, dev)
    out = {}
    for rank, batches in by_rank.items():
        for name, run, pairs, got_fn in batches:
            ok, c = slab_pass(run, pairs, got_fn)
            got = (c["halo_copy_launches"], c["halo_copy_slabs"])
            want = (-(-len(pairs) // hc.MAX_SLABS), len(pairs))
            print(f"  rank {rank} {name}: {got[1]} slabs in {got[0]} "
                  f"launch(es), {tuple(pairs[0][0].shape)} first, bit for "
                  f"bit {ok}", flush=True)
            if not ok or got != want:
                bad.append(f"slab copy rank {rank} {name}: bit for bit "
                           f"{ok}, (launches, slabs) {got}, expected {want}")
        step = halo_copy_step(batches)
        reset_counts()
        for _, run, _, _ in step:
            run()
        c = read_counts()
        out[rank] = (c["halo_copy_launches"], c["halo_copy_slabs"])
        shards = cfg.sharding.mesh_lat * cfg.sharding.mesh_lon
        launches, slabs = halo_copies(cfg, ranks=True)
        if out[rank] != (launches // shards, slabs // shards):
            bad.append(f"slab copy rank {rank}: a step counts "
                       f"{out[rank]}, expected {launches // shards} "
                       f"launches and {slabs // shards} slabs")
    return dict(counts=out, batches=by_rank)


def halo_copy_path(dev, card: str) -> list:
    """Phase 19: the ghost exchange's batched slab copy at #5's 2x2 blocks
    (``halo_copy_check``), then each rank's step of copies timed against
    its per-slab copies, in turns, beside the bound of its bytes read and
    written; its entries of the ``kernels`` line."""
    bad = []
    cfg = halo_copy_config()
    res = halo_copy_check(cfg, dev, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    entries = []
    for rank, batches in res["batches"].items():
        step = halo_copy_step(batches)
        pairs = [p for _, _, ps, _ in step for p in ps]
        n_bytes = sum(2 * d.numel() * d.element_size() for d, _ in pairs)

        def kern(step=step):
            for _, run, _, _ in step:
                run()

        def plain(pairs=pairs):
            for d, s in pairs:
                d.copy_(s)
        tm = kernel_timing(f"slab_copy, a step of rank {rank}", kern, plain,
                           bound_ms(n_bytes, 0, dev), card)
        launches, slabs = res["counts"][rank]
        entries.append({
            "name": f"slab_copy_rank{rank}", "route": "cuda",
            "source": "climate_model_tpu_torch/kernels/csrc/halo_copy.cu",
            "replaces": HALO_COPY_REPLACES,
            "path": "ghost exchange and seam strips, a step of a rank of "
                    "#5 on 2x2 with halo overlap",
            "launches": launches, "slabs": slabs, "bytes": n_bytes,
            # a copy: every batch equal to the per-slab copies bit for bit
            "max_abs_err": 0.0, "bit_for_bit": True,
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "plain_launches": len(pairs),
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "launch_ms": tm["launch_ms"],
            "enqueue_ms": tm["enqueue_ms"],
            "plain_enqueue_ms": tm["plain_enqueue_ms"]})
    return entries


def on_mesh(argv, n_lat: int, n_lon: int) -> list:
    return argv + ["--mesh-lat", str(n_lat), "--mesh-lon", str(n_lon)]


# The rank worker's runs through cli.run, each writing its checkpoint set:
# (b) #5 on 2x2 over phase 14's 150 steps in both schedules, (c) #4 on 1x4
# (a 4-wide lon ring, no lat exchange) and on 4x1 (interior ranks with two
# lat neighbours, no column exchange), (e) the plain backend on 2x2 over
# phase 12's 20 steps, per-operator halos (DistEdges) and GSPMD auto
# (DTensors)
MC_RUNS = (
    ("b5_2x2_overlap", on_mesh(B5_OVERLAP_ARGV, 2, 2)),
    ("b5_2x2_blocking", on_mesh(B5_ARGV, 2, 2)),
    ("b4_1x4_blocking", on_mesh(MC_B4_50_ARGV, 1, 4)),
    ("b4_4x1_overlap", on_mesh(MC_B4_50_ARGV + ["--halo-overlap"], 4, 1)),
    ("jnp_2x2_shard_map", on_mesh(JNP_MESH_ARGV, 2, 2)),
    ("jnp_2x2_auto", on_mesh(JNP_AUTO_ARGV, 2, 2)),
)
# (f) (a)'s overlap run split at step 129 and resumed on the same ranks
MC_RESUMED = "b4_2x2_resumed"
# (d) planted faults on 2x2 with halo overlap, FAULT_STEPS steps from the
# noisy #4 state; each but the first must break SHARDED_TOL, and for the
# lat exchange left out after the predictor only, a reading: on four H100s
# it moved v by 1.5e-8 m/s and nothing else, as phase 8's lon exchange
# after the predictor moves nothing. The predictor's seam strips write the
# ghost rows too, from the freshly exchanged rows: the inner ghost row
# equals the neighbour's bit for bit, the second too but for v at a south
# seam (the strip's own edge row reaches it), the outermost not at all;
# what the corrector's kept rows read of them moves the result by rounding
# only (tests/test_torch_multicard.py::test_ghost_rows_after_the_predictor).
# Swapping the order of the column sends is no fault where the transport
# honours tags (gloo); NCCL matches a pair's messages in post order, and on
# a 2-wide ring both lon neighbours are one rank, so the seams get each
# other's columns.
MC_FAULTS = (("none (sound)", {}),
             ("lat exchange left out", {"leave_out": "lat exchange"}),
             ("lat exchange left out after the predictor only",
              {"leave_out": "lat exchange after the predictor"}),
             ("east/west posting order swapped",
              {"lon_sends": ("west", "east")}),
             ("ghosts one row and column narrower (2)", {"halo": (2, 2, 2)}))
# ... and the plain backend's: on shard_map a planted shift fault of
# JNP_MESH_FAULTS; on auto the lon roll of west/east kept to each rank's
# own columns (the DTensor's placements kept, no data from the neighbour)
MC_JNP_FAULT = "lat exchange left out (zero rows at every shard edge)"
MC_AUTO_FAULT = "lon roll within each rank's columns (placements kept)"


def roll_within_rank(shift: int):
    """``torch.roll`` along lon that, on a DTensor, rolls each rank's own
    columns and keeps the placements: the seam columns wrap within the
    rank (the planted fault MC_AUTO_FAULT)."""
    def roll(a):
        from torch.distributed.tensor import DTensor
        if not isinstance(a, DTensor):
            return torch.roll(a, shift, dims=-1)
        return DTensor.from_local(torch.roll(a.to_local(), shift, dims=-1),
                                  a.device_mesh, a.placements,
                                  run_check=False)
    return roll


# (e)'s bounds: shard_map runs the same per-point arithmetic on each rank
# and is held to JNP_MESH_TOL (bit for bit on the card). auto is bit for
# bit across gloo ranks on the CPU (fp32 and fp64) and across NCCL ranks on
# 4x1, but not where lon is sharded (1x4, 2x2; PERF.md). Four H100s read
# on 2x2, over the 20 steps: u 1.241e-4 m/s, v 6.473e-5, pott 2.136e-4 K,
# qv 4.191e-9, colp 2.344e-2 Pa, 0 elsewhere (the same in four calls); over
# the JNP_FAULT_STEPS from the noisy #4 state, near saturation: u 1.165e-4,
# v 3.317e-5, pott 7.935e-4, qv 3.073e-7, qc 3.033e-7, colp 2.344e-2, rain
# 3.062e-6, soil_moist 1.863e-9 (the microphysics' threshold turns a last
# bit into the size of the kernel's own error against its plain version).
# Each bound is 4x the larger reading, and never below JNP_MESH_TOL's
# (3-6 ulp), the bound of tsurf, which read 0; MC_AUTO_FAULT broke it in
# every field but tsurf and soil_moist, by 30x (qc) and more.
MC_AUTO_READ = {"u": 1.241e-4, "v": 6.473e-5, "pott": 7.935e-4,
                "qv": 3.073e-7, "qc": 3.033e-7, "colp": 2.344e-2,
                "rain": 3.062e-6, "soil_moist": 1.863e-9}
MC_AUTO_TOL = {f: max(4 * MC_AUTO_READ.get(f, 0.0), t)
               for f, t in JNP_MESH_TOL.items()}
# (d) on the plain path: (set prefix, the (e) run whose config it takes,
# fault, its shift primitives of dycore/boundaries.py, bound)
MC_PLAIN_FAULTS = (
    ("jnp_fault", "jnp_2x2_shard_map", MC_JNP_FAULT,
     JNP_MESH_FAULTS[MC_JNP_FAULT], JNP_MESH_TOL),
    ("auto_fault", "jnp_2x2_auto", MC_AUTO_FAULT,
     dict(west=roll_within_rank(1), east=roll_within_rank(-1)), MC_AUTO_TOL))
# steps of each packed mesh run again after its run (the NCCL connections
# of the run's peers made), after a warm run and in turns with the exchange
# clock off and on: the exchange's steady ms a step and what the clock
# costs. The runs themselves are timed with the clock off.
MC_CLOCK_STEPS = 50
# (g) bench --scaling --multihost on the 2x2 mesh of a namelist: (name,
# baseline, further flags); bench's default of 50 steps a timed run
MC_BENCH = (("b4_2x2_overlap", 4, ["--halo-overlap"]), ("b5_2x2", 5, []))
# (h) the shard-local and seam-strip variants at every block shape that
# (a)-(c) give them, cut from the noisy state of the baseline: (entry
# suffix, baseline, blocks (name, mesh, shard) as CHECK_BLOCKS, the
# variants timed on each block, the counted worker runs whose launches the
# entries report). On 2x2 the south row's block (the polar wall, north
# ghosts and strip, the lon seam) and the north row's (south ghosts and
# strip), launched by (a)'s overlap run split and resumed and by (b); on
# 1x4 a block of the 4-wide lon ring (blocking: no strip), by (c); on 4x1
# an interior block (ghost rows and a strip on both sides), by (c).
MC_2X2_BLOCKS = (("2x2 south row", (2, 2), 0), ("2x2 north row", (2, 2), 2))
MC_2X2_TIMING = (("2x2 south row", ("predictor_shard", "corrector_shard",
                                    "predictor_north_strip",
                                    "corrector_north_strip")),
                 ("2x2 north row", ("predictor_south_strip",
                                    "corrector_south_strip")))
# what the start line of a packed run across ranks says (graphs.py::
# describe): the compiled chunk, its NCCL posts captured in the graph
MC_COMPILED = "NCCL posts captured in the step's graph"
MC_KERNEL_CASES = (
    ("b4_2x2", 4, MC_2X2_BLOCKS, MC_2X2_TIMING, (MC_RESUMED,)),
    ("b5_2x2", 5, MC_2X2_BLOCKS, MC_2X2_TIMING,
     ("b5_2x2_overlap", "b5_2x2_blocking")),
    ("b4_1x4", 4, (("1x4 ring", (1, 4), 1),),
     (("1x4 ring", ("predictor_shard", "corrector_shard")),),
     ("b4_1x4_blocking",)),
    ("b4_4x1", 4, (("4x1 interior", (4, 1), 1),),
     (("4x1 interior", ("predictor_shard", "corrector_shard",
                        "predictor_south_strip", "corrector_south_strip",
                        "predictor_north_strip", "corrector_north_strip")),),
     ("b4_4x1_overlap",)))


def unsharded_argv(argv) -> list:
    """``argv`` without its mesh, sharding mode and halo overlap, on a 1x1
    mesh: the same grid on one card."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--mesh-lat", "--mesh-lon", "--sharding-mode"):
            skip = True
        elif a != "--halo-overlap":
            out.append(a)
    return on_mesh(out, 1, 1)


def argv_config(argv):
    return cli.build_config(cli.make_parser().parse_args(argv))


def mesh_namelist(baseline: int, n_lat: int, n_lon: int, path: str) -> str:
    """``configs/baseline_N.toml`` with its mesh set to ``n_lat`` x
    ``n_lon``, written to ``path``; returns ``path``."""
    with open(os.path.join(ROOT, "configs", f"baseline_{baseline}.toml")) as f:
        text = f.read()
    for key, n in (("mesh_lat", n_lat), ("mesh_lon", n_lon)):
        text, k = re.subn(rf"(?m)^{key} = \d+$", f"{key} = {n}", text)
        if k != 1:
            raise ValueError(f"baseline_{baseline}.toml: no one {key} line")
    with open(path, "w") as f:
        f.write(text)
    return path


def set_path(root: str, name: str) -> str:
    """Where the checkpoint set of the case ``name`` lies."""
    return os.path.join(root, name, "restart.npz")


def read_set(path: str, cfg, want, dev) -> tuple:
    """The ``.p*`` checkpoint set at ``path``, loaded in this process
    (``load_checkpoint``), against the state ``want``: (equal bit for bit,
    step and time included; max|diff| of each field)."""
    got = load_checkpoint(path, cfg, device=dev)
    same = (bitwise_equal(got, want, STATE_FIELDS) and got.step == want.step
            and bool(got.t == want.t))
    return same, state_diffs(got, want)


def sum_counts(ranks: list, name: str) -> dict:
    """The counts of the case ``name`` summed over the ranks' records."""
    out = collections.Counter()
    for r in ranks:
        out.update(r[name]["counts"])
    return out


def torchrun(args, timeout: float, log: str):
    """``torchrun --standalone --nproc-per-node MC_WORLD`` of ``args`` from
    the repository's root, in a session of its own that is killed whole
    after ``timeout`` seconds; its output goes to ``log`` and is printed.
    Returns whether every rank exited 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(MC_WORLD), *args]
    print(f"  $ torchrun --standalone --nproc-per-node {MC_WORLD} "
          + " ".join(args), flush=True)
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = None
    with open(log) as f:
        text = f.read()
    print("".join(f"  | {line}\n" for line in text.splitlines()), end="",
          flush=True)
    wall = time.perf_counter() - t0
    what = "killed: still running" if rc is None else f"exited {rc}"
    print(f"  torchrun {what} after {wall:.1f} s", flush=True)
    return rc == 0


# --- the rank side: chip_smoke.py --rank-worker DIR under torchrun ---

def run_record(res, counts: dict) -> dict:
    """What the parent reads of a rank's run: the chunk loop's decisions,
    its ms/step, the launch counts and the shifts of the plain mesh path."""
    steady = 1e3 * sum(r["wall_s"] for r in res.records[1:]) \
        / max(sum(res.chunks[1:]), 1)
    return dict(steps=res.steps, start_step=res.start_step,
                chunks=res.chunks, dts=res.dts, path=res.path,
                wall_s=res.wall_s, steady_ms=steady, counts=counts,
                shifts=halo.make_sharded_step_fn.shifts)


def ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def steady_exchange(recs) -> str:
    """``worker_clocked``'s readings over the ranks."""
    def each(key):
        return ", ".join(ms(r[key]) for r in recs)
    return (f"{MC_CLOCK_STEPS} steps again, in turns: {each('clock_off_ms')} "
            f"ms/step with the exchange clock off, {each('clock_on_ms')} on, "
            f"{recs[0]['steady_exchanges']:.0f} exchanges a step taking "
            f"{each('steady_host_ms')} host ms and {each('steady_device_ms')} "
            "device ms a step (each rank)")


def counting():
    """Every counter set to 0."""
    reset_counts()
    halo.make_sharded_step_fn.shifts = 0


def worker_run(argv, dev, root: str, name: str) -> dict:
    """``cli.run`` of ``argv`` on this rank, counted, its checkpoint set in
    the case's folder; on the packed scan then ``worker_clocked``."""
    counting()
    res = cli.run(argv_config(argv), device=dev,
                  out_dir=os.path.dirname(set_path(root, name)), no_nc=True)
    rec = run_record(res, read_counts())
    if model.takes_packed_scan(argv_config(argv)):
        rec.update(worker_clocked(argv, dev))
    return rec


def worker_clocked(argv, dev, n: int = MC_CLOCK_STEPS) -> dict:
    """``n`` steps of ``argv``'s mesh from its initial state, after a warm
    run, in turns with the exchange clock off, on, on and off, each run
    started at a barrier and ended by a synchronize. Returns this rank's
    mean ms/step of each and the clock's host and device ms a step."""
    cfg = argv_config(argv)
    s, f, g = initialize(cfg, device=dev)
    ss = sharding.shard(make_mesh(cfg, device=dev), s, g, f)
    # the clock measures the eager exchange (graphs.py: a captured
    # exchange reads no clock)
    run = make_chunk_runner(cfg, n, graphs=False)
    run(ss, g, f)
    clock = comm.ExchangeClock()
    out = {"clock_off_ms": 0.0, "clock_on_ms": 0.0}
    for key in ("clock_off_ms", "clock_on_ms", "clock_on_ms",
                "clock_off_ms"):
        barrier(dev)
        t0 = time.perf_counter()
        comm.DistExchange.clock = clock if key == "clock_on_ms" else None
        try:
            run(ss, g, f)
            sync(dev)
        finally:
            comm.DistExchange.clock = None
        out[key] += 1e3 * (time.perf_counter() - t0) / (2 * n)
    dev_ms = clock.device_ms()
    out.update(steady_exchanges=clock.exchanges / (2 * n),
               steady_host_ms=1e3 * clock.host_s / (2 * n),
               steady_device_ms=None if dev_ms is None else dev_ms / (2 * n))
    return out


def worker_resume(dev, root: str) -> dict:
    """(f): (a)'s overlap run to step 129, then resumed from its checkpoint
    set on the same ranks to the horizon; rank 0 also writes the gathered
    final state (``gathered.npz``)."""
    cfg = argv_config(MC_CLI_RUNS[0][1])
    out = os.path.dirname(set_path(root, MC_RESUMED))
    counting()
    r1 = cli.run(cfg.replace(sim_days=IO4_SPLIT_DAYS), device=dev,
                 out_dir=out, no_nc=True)
    r2 = cli.run(cfg, device=dev, out_dir=out, no_nc=True,
                 restart_from=set_path(root, MC_RESUMED))
    if tdist.get_rank() == 0:
        np.savez(os.path.join(root, "gathered.npz"),
                 **state_to_numpy(r2.state))
    return dict(run_record(r2, read_counts()), split_steps=r1.steps,
                **worker_clocked(MC_CLI_RUNS[0][1], dev))


def load_state(path: str, dev):
    """A ``State`` written with ``np.savez(path, **state_to_numpy(s))``, at
    the file's dtype."""
    with np.load(path) as z:
        return state_from_numpy(dict(z), device=dev,
                                dtype=getattr(torch, str(z["u"].dtype)))


def load_noisy(root: str, dev):
    """The parent's noisy state (``noisy.npz``) with the forcing and grid
    of (a)'s grid: a ``noisy_state`` tuple."""
    cfg = argv_config(unsharded_argv(MC_CLI_RUNS[0][1]))
    _, forcing, grid = initialize(cfg, device=dev)
    return cfg, load_state(os.path.join(root, "noisy.npz"), dev), forcing, \
        grid


def worker_faults(noisy, dev, root: str):
    """(d) on the packed path and (e)'s shift fault on the plain path, from
    the noisy state, each to a checkpoint set."""
    cfg = argv_config(MC_CLI_RUNS[0][1])
    for i, (_, kw) in enumerate(MC_FAULTS):
        sends = {"LON_SENDS": kw["lon_sends"]} if "lon_sends" in kw else {}
        with planted(comm.DistExchange, **sends):
            out = sharded_blocks(
                cfg, noisy, FAULT_STEPS, dev,
                halo=sharding.Halo(*kw.get("halo", ())),
                leave_out=kw.get("leave_out"))
        save_checkpoint(set_path(root, f"fault{i}"), out, cfg)
    _, s0, f0, g0 = noisy
    for prefix, name, _, fault, _ in MC_PLAIN_FAULTS:
        cfg = argv_config(dict(MC_RUNS)[name])
        for i, prims in enumerate(({}, fault)):
            ss = sharding.shard(make_mesh(cfg, device=dev), s0, g0, f0,
                                halo.NO_HALO)
            with planted(bc, **prims):
                out = make_chunk_runner(cfg, JNP_FAULT_STEPS)(ss, g0, f0)
            save_checkpoint(set_path(root, f"{prefix}{i}"), out, cfg)


def worker_bench(dev, root: str) -> dict:
    """(g): ``bench --scaling --multihost`` on each namelist of MC_BENCH
    (rank 0 writes it, the others wait); rank 0's JSON lines (the other
    ranks print none)."""
    lines = {}
    for name, baseline, flags in MC_BENCH:
        toml = os.path.join(root, f"{name}.toml")
        if tdist.get_rank() == 0:
            mesh_namelist(baseline, 2, 2, toml)
        barrier(dev)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--scaling", "--multihost", "--config",
                           toml, *flags])
        if rc != 0:
            raise AssertionError(f"bench {name} returned {rc}: "
                                 f"{buf.getvalue()}")
        lines[name] = buf.getvalue().strip().splitlines()
    return lines


def worker_cases(dev, root: str):
    """Every case that the rank worker runs, on this rank of the process
    group; its records in ``rank{r}.json``."""
    rank = tdist.get_rank()
    rec = {}
    for name, argv in MC_RUNS:
        if rank == 0:
            print(f"[rank worker] {name}", flush=True)
        rec[name] = worker_run(argv, dev, root, name)
    rec[MC_RESUMED] = worker_resume(dev, root)
    worker_faults(load_noisy(root, dev), dev, root)
    rec["bench"] = worker_bench(dev, root)
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def rank_worker(root: str) -> int:
    """One rank of phase 16 under torchrun, one card each."""
    if not torch.cuda.is_available():
        raise RuntimeError("the rank worker needs a card")
    with cli.multihost("cuda") as dev:
        worker_cases(dev, root)
    return 0


# --- the parent side: one card for the references, four for the ranks ---

def mc_kernels(noisy4, dev, card: str, bad: list) -> dict:
    """(h): the shard-local and seam-strip variants at the blocks of
    MC_KERNEL_CASES against their plain versions, timed. Returns {suffix:
    (errors, timing)}."""
    out = {}
    for baseline in (4, 5):
        noisy = noisy4 if baseline == 4 else noisy_state(baseline, dev)
        for suffix, n, blocks, plan, _ in MC_KERNEL_CASES:
            if n != baseline:
                continue
            print(f"  #{n}, {suffix}:", flush=True)
            errs, inputs = check_shards(noisy, dev, bad, blocks)
            out[suffix] = (errs, time_shards(inputs, card, plan))
            del inputs
        del noisy
    return out


class References:
    """The unsharded runs on one card that the ranks' runs must equal, each
    run once (``run_argv``) and kept by its command."""

    def __init__(self, dev, card: str):
        self.dev, self.card, self.runs = dev, card, {}

    def __call__(self, argv):
        key = tuple(unsharded_argv(argv))
        if key not in self.runs:
            cfg, res, _, steady = run_argv(list(key), self.dev)
            print(f"  reference {' '.join(key[1:])}: {res.path}; "
                  f"{res.steps} steps {res.chunks}, after the first chunk "
                  f"{steady:.3f} ms/step [{self.card}]", flush=True)
            self.runs[key] = (cfg, res)
        return self.runs[key]


def mc_compare(label, path, cfg, want, bad: list, tol=None) -> bool:
    """The set at ``path`` against ``want``: bit for bit, or with ``tol``
    (a dict of bounds) within it; prints the reading."""
    same, per = read_set(path, cfg, want, want.u.device)
    shown = {f: per[f] for f in (tol or SHARDED_TOL)}
    print(f"  {label}: bitwise equal {same}; "
          + show(shown, tol or SHARDED_TOL), flush=True)
    if tol is None and not same:
        bad.append(f"{label}: not bit for bit")
    if tol is not None:
        bad += [f"{label}: {x} over its bound" for x in over(shown, tol)]
    return same


def mc_cli_files(name, out: str, ref, bad: list):
    """(a)'s folder: one checkpoint file a rank, rank 0's NetCDF file a
    chunk and metrics line a chunk at the reference's steps and dts, its
    last NetCDF file equal to the reference's final state."""
    res = ref[1]
    n = len(res.chunks)
    want = sorted(["constants.nc", "metrics.jsonl"]
                  + [f"out_{i:04d}.nc" for i in range(n)]
                  + [f"restart.npz.p{r}" for r in range(MC_WORLD)])
    got = sorted(os.listdir(out))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [int(x) for x in np.cumsum(res.chunks)]
    dts = [r.get("dt", res.dts[0]) for r in recs]
    last = nc_vars(os.path.join(out, f"out_{n - 1:04d}.nc"))
    s = res.state
    nc_ok = all(np.array_equal(last[k][0], getattr(s, f).cpu().numpy())
                for k, f in NC_FIELDS.items())
    print(f"  {name} files: {got}; metrics steps "
          f"{[r['step'] for r in recs]}, dts {dts}; the last NetCDF file "
          f"equals the unsharded final state: {nc_ok}", flush=True)
    if got != want:
        bad.append(f"{name}: files {got}, expected {want}")
    if [r["step"] for r in recs] != steps or dts != res.dts:
        bad.append(f"{name}: metrics steps/dts {recs}, expected {steps}, "
                   f"{res.dts}")
    if not nc_ok:
        bad.append(f"{name}: the last NetCDF file differs from the "
                   "unsharded state")


def mc_runs(ranks, refs, root, card, bad: list):
    """(b), (c) and (e): each rank worker run against its unsharded
    reference, counted and timed."""
    for name, argv in MC_RUNS:
        cfg, ref = refs(argv)
        recs = [r[name] for r in ranks]
        counts = sum_counts(ranks, name)
        plain = name.startswith("jnp")
        steady = max(r["steady_ms"] for r in recs)
        line = (f"  {name}: {recs[0]['path']}; {recs[0]['steps']} steps "
                f"{recs[0]['chunks']}, after the first chunk {steady:.3f} "
                f"ms/step (slowest rank; "
                f"{', '.join(f'{r['steady_ms']:.3f}' for r in recs)}); ")
        if plain:
            line += (f"{recs[0]['shifts'] / recs[0]['steps']:.1f} shifts a "
                     f"step a rank; ")
            launched = {k: v for k, v in counts.items()
                        if k not in PLAIN_COUNTERS and v}
            if launched:
                bad.append(f"{name}: kernel launches {launched}")
        else:
            line += f"{steady_exchange(recs)}; "
            bad += [f"{name}: a rank ran {r['path']!r}, not the compiled "
                    "chunk" for r in recs if MC_COMPILED not in r["path"]]
            want = want_counts(argv_config(argv), recs[0]["steps"], counts,
                               ranks=True)
            if counts != want:
                bad.append(f"{name}: counts {counts}, expected {want}")
        print(line + f"counts over the ranks "
              f"{ {k: v for k, v in counts.items() if v} } [{card}]",
              flush=True)
        for r in recs:
            if r["dts"] != ref.dts or r["chunks"] != ref.chunks:
                bad.append(f"{name}: chunks {r['chunks']} dts {r['dts']}, "
                           f"unsharded {ref.chunks} {ref.dts}")
        mc_compare(f"{name} vs unsharded", set_path(root, name),
                   argv_config(argv), ref.state, bad,
                   tol=(MC_AUTO_TOL if name.endswith("auto")
                        else JNP_MESH_TOL) if plain else None)


def mc_resume(ranks, root, dev, bad: list):
    """(f): the split run's set equals (a)'s continuous set and rank 0's
    gathered state bit for bit; a set missing a file is refused."""
    rec = ranks[0][MC_RESUMED]
    cfg = argv_config(MC_CLI_RUNS[0][1])
    cont = load_checkpoint(set_path(root, MC_CLI_RUNS[0][0]), cfg,
                           device=dev)
    print(f"  {MC_RESUMED}: {rec['split_steps']} steps, resumed at step "
          f"{rec['start_step']} for {rec['steps']} steps on the same ranks",
          flush=True)
    if rec["start_step"] != rec["split_steps"] \
            or rec["split_steps"] + rec["steps"] != cont.step:
        bad.append(f"{MC_RESUMED}: {rec}")
    mc_compare(f"{MC_RESUMED} vs the continuous run", set_path(
        root, MC_RESUMED), cfg, cont, bad)
    gathered = load_state(os.path.join(root, "gathered.npz"), dev)
    mc_compare(f"{MC_RESUMED}: the set loaded in one process vs the "
               "gathered state", set_path(root, MC_RESUMED), cfg, gathered,
               bad)
    part = os.path.join(root, "missing_p2")
    os.makedirs(part)
    for r in (0, 1, 3):
        shutil.copy(f"{set_path(root, MC_RESUMED)}.p{r}", part)
    try:
        load_checkpoint(os.path.join(part, "restart.npz"), cfg, device=dev)
        bad.append("a checkpoint set without .p2 was loaded")
        print("  the set without .p2: loaded", flush=True)
    except ValueError as e:
        print(f"  the set without .p2: refused ({e})", flush=True)


def mc_faults(noisy, root, bad: list):
    """(d) and (e)'s fault: the sound runs from the noisy state within the
    bound, each planted fault over it."""
    _, s0, f0, g0 = noisy
    for faults, argv, prefix, n, tol in (
            (MC_FAULTS, MC_CLI_RUNS[0][1], "fault", FAULT_STEPS,
             SHARDED_TOL),
            *(((("none (sound)", {}), (fault, {})), dict(MC_RUNS)[name],
               prefix, JNP_FAULT_STEPS, tol)
              for prefix, name, fault, _, tol in MC_PLAIN_FAULTS)):
        cfg = argv_config(argv)
        want = make_chunk_runner(argv_config(unsharded_argv(argv)), n)(
            s0, g0, f0)
        for i, (fault, _) in enumerate(faults):
            same, per = read_set(set_path(root, f"{prefix}{i}"), cfg, want,
                                 want.u.device)
            shown = {f: per[f] for f in tol}
            mode = f" {cfg.sharding.mode}" if cfg.backend == "jnp" else ""
            print(f"  noisy #4 state, {n} steps, backend={cfg.backend}{mode} "
                  f"on 2x2 across ranks, planted fault: {fault}; vs "
                  f"unsharded, "
                  f"bitwise equal {same}: " + show(shown, tol), flush=True)
            if i == 0:
                bad += [f"sound {prefix} run: {x} over its bound"
                        for x in over(shown, tol)]
            elif "after the predictor only" in fault:
                pass        # a reading, not a gate (MC_FAULTS)
            elif not over(shown, tol):
                bad.append(f"the {fault} stays within every bound")


def mc_bench(ranks, card: str, bad: list):
    """(g): rank 0's one JSON line of each bench, none from the others;
    the exchange's ms a step beside it, from the clocked runs of the same
    mesh and schedule."""
    clocked = {"b4_2x2_overlap": MC_RESUMED, "b5_2x2": "b5_2x2_blocking"}
    for name, baseline, flags in MC_BENCH:
        lines = ranks[0]["bench"][name]
        others = [r["bench"][name] for r in ranks[1:]]
        rec = json.loads(lines[-1])
        gc = baseline_config(baseline).grid
        npts = gc.nx * gc.ny * gc.nz
        ex = [r[clocked[name]] for r in ranks]
        print(f"  bench --scaling --multihost --config {name}.toml "
              f"{' '.join(flags)}: {lines[-1]}", flush=True)
        print(f"    value {rec['value']}, gps_1dev {rec['gps_1dev']}, "
              f"gps_ndev {rec['gps_ndev']}, gps_ratio {rec['gps_ratio']}, "
              f"vs_baseline {rec['vs_baseline']} (the BASELINE's 0.80); "
              f"{1e3 * npts / rec['gps_1dev']:.3f} ms/step on one card, "
              f"{1e3 * npts / rec['gps_ndev']:.3f} across the ranks; "
              f"{clocked[name]}'s {steady_exchange(ex)} [{card}]",
              flush=True)
        if len(lines) != 1 or any(others) \
                or f"{MC_WORLD} ranks (nccl)" not in rec["metric"] \
                or rec["n_devices"] != MC_WORLD or not rec["value"] > 0:
            bad.append(f"bench {name}: rank 0 printed {lines}, the others "
                       f"{others}")


def multicard_path(dev, card: str) -> list:
    """Phase 16: the paths across ranks, one card each, held against the
    same runs on one card. Returns the ``kernels`` entries of the variants
    at the blocks of MC_KERNEL_CASES."""
    bad = []
    root = tempfile.mkdtemp(prefix="chip_smoke_cards_")
    try:
        noisy = noisy_state(4, dev)
        np.savez(os.path.join(root, "noisy.npz"),
                 **state_to_numpy(noisy[1]))
        kern = mc_kernels(noisy, dev, card, bad)
        if bad:
            raise AssertionError("; ".join(bad))
        # every launch runs; a failed one fails the phase at its end, after
        # the others' readings
        ran = {}
        for name, argv in MC_CLI_RUNS:
            ran[name] = torchrun(
                ["-m", "climate_model_tpu_torch", *argv, "--multihost",
                 "--out-dir", os.path.dirname(set_path(root, name))],
                MC_TIMEOUT_S["run"], os.path.join(root, f"{name}.log"))
        ran["worker"] = torchrun(
            [os.path.join(ROOT, "chip_smoke.py"), "--rank-worker", root],
            MC_TIMEOUT_S["worker"], os.path.join(root, "worker.log"))
        bad += [f"the {name} launch failed" for name, ok in ran.items()
                if not ok]
        card4 = f"{MC_WORLD} x {card}"
        refs = References(dev, card)
        for name, argv in MC_CLI_RUNS:
            if not ran[name]:
                continue
            ref = refs(argv)
            mc_cli_files(name, os.path.dirname(set_path(root, name)), ref,
                         bad)
            mc_compare(f"{name} (run --multihost) vs unsharded",
                       set_path(root, name), argv_config(argv), ref[1].state,
                       bad)
        if not ran["worker"]:
            raise AssertionError("; ".join(bad))
        for name, _ in MC_CLI_RUNS:
            # the start line names the design: the posts in the graph
            with open(os.path.join(root, f"{name}.log")) as f:
                if ran[name] and MC_COMPILED not in f.read():
                    bad.append(f"{name}: its start line does not say "
                               f"'{MC_COMPILED}'")
        ranks = []
        for r in range(MC_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        mc_runs(ranks, refs, root, card4, bad)
        if ran[MC_CLI_RUNS[0][0]]:
            mc_resume(ranks, root, dev, bad)
        mc_faults(noisy, root, bad)
        mc_bench(ranks, card4, bad)
        if bad:
            raise AssertionError("; ".join(bad))
        kernels = []
        for suffix, n, _, _, runs in MC_KERNEL_CASES:
            errs, timing = kern[suffix]
            mesh = suffix.split("_")[1]
            for kname, tm in timing.items():
                epi = kname.startswith("corrector")
                e = kernel_entry(
                    kname, "physics_epilogue.cu" if epi
                    else "fused_substep.cu",
                    f"sharded packed scan across {MC_WORLD} cards, "
                    f"BASELINE #{n} on {mesh} ({', '.join(runs)})",
                    sum(sum_counts(ranks, r)[kname] for r in runs),
                    errs[kname], SHARD_EPI_TOL if epi else SHARD_TOL, tm)
                if not e["launches"]:
                    bad.append(f"{e['name']}_{suffix}: no launch in "
                               f"{runs}")
                kernels.append(dict(e, name=f"{e['name']}_{suffix}"))
        if bad:
            raise AssertionError("; ".join(bad))
        return kernels
    finally:
        shutil.rmtree(root, ignore_errors=True)


def kernel_entry(kname, source, path, launches, err, tol, tm,
                 replaces="climate_model_tpu/kernels/fused_substep.py:1047"
                 ) -> dict:
    """One variant's entry of the ``kernels`` line."""
    return {
        "name": f"fused_substep_{kname}", "route": "cuda",
        "source": f"climate_model_tpu_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "path": path, "launches": launches,
        # fields differ in units: the max is colp's (Pa); each field's
        # error and the largest error/bound ratio are listed beside it
        "max_abs_err": max(err.values()),
        "max_abs_err_by_field": err,
        "max_err_over_tol": max(e / tol[f] for f, e in err.items()),
        "ms": tm["ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None,
        # device ms of each launch of one call (profiled)
        "launch_ms": tm["launch_ms"],
        # ms and plain_ms are device time; the host's time to enqueue
        # one call
        "enqueue_ms": tm["enqueue_ms"],
        "plain_enqueue_ms": tm["plain_enqueue_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multicard", action="store_true",
                    help=f"phases 1-2, then phase 16 alone on {MC_WORLD} "
                         "cards")
    ap.add_argument("--rank-worker", metavar="DIR",
                    help="one rank of phase 16 (torchrun starts these)")
    args = ap.parse_args(argv)
    if args.rank_worker:
        return rank_worker(args.rank_worker)

    # ---- 1. device ----
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    if args.multicard and count < MC_WORLD:
        raise RuntimeError(f"--multicard needs {MC_WORLD} cards; "
                           f"torch.cuda.device_count() is {count}")
    card = card_line()
    print(f"device: {kind} x{count}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    print(card, flush=True)
    phase("device", t)

    # ---- 2. build ----
    t = time.perf_counter()
    info = fs.build(force=True)
    for name, lines in ptxas_lines(info.log):
        print(f"  ptxas {name}: " + " | ".join(lines), flush=True)
    phase("build", t, f"nvcc {info.seconds:.2f}s -> {info.path}")

    if args.multicard:
        # ---- 16. the paths across cards ----
        t = time.perf_counter()
        kernels = multicard_path(dev, card)
        phase("across cards", t, f"#4 and #5 on 2x2 and #4 on 1x4 and 4x1 "
              f"across {MC_WORLD} cards equal their one-card runs bit for "
              "bit; the plain mesh path within its bound; resumed across "
              "ranks bit for bit; each planted fault breaks a bound")
        print(json.dumps({"kernels": kernels}), flush=True)
        cards = card_lines()
        print(f"{len(cards)} cards: " + "; ".join(cards), flush=True)
        print(card, flush=True)
        print(f"total {time.perf_counter() - T0:.1f}s", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": MC_WORLD}}),
            flush=True)
        return 0

    # ---- 3. kernels vs plain at config #3 ----
    t = time.perf_counter()
    ci = check_inputs(dev)
    errs = check_kernels(ci)
    bad = []
    check_momentum(ci, bad)
    check_tall(dev, bad)
    noisy = noisy_state(4, dev)
    shard_errs, shard_inputs = check_shards(noisy, dev, bad)
    if bad:
        raise AssertionError("; ".join(bad))
    phase("check", t, "every variant agrees with its plain version at "
          f"{tuple(ci.state.u.shape)} fp32, on {TALL_NZ} levels, and on "
          "#4's shard blocks and seam strips; each planted fault breaks a "
          "bound")

    # ---- 4. timing ----
    t = time.perf_counter()
    timing = time_kernels(ci, card)
    shard_timing = time_shards(shard_inputs, card)
    del shard_inputs
    phase("timing", t)

    # ---- 5. main path: the packed scan ----
    t = time.perf_counter()
    run_cfg, res, main_counts, steady_ms = main_path(dev, card)
    phase("main", t, "config #3 through cli.run on the packed scan")

    # ---- 6. the per-step path beside it ----
    t = time.perf_counter()
    step_counts, _, _, _ = per_step_path(run_cfg, res.chunks[0], dev, card)
    phase("per-step", t, "the per-step path driven and checked; both paths "
          "agree")

    # ---- 7. where a step's time goes ----
    t = time.perf_counter()
    breakdown(run_cfg, res.state, res.grid, res.forcing, steady_ms, card)
    phase("breakdown", t)

    # ---- 8. BASELINE #4 on its mesh: the sharded packed scan ----
    t = time.perf_counter()
    sharded_counts = sharded_path(noisy, dev, card)
    phase("sharded", t, "#4 on 2x4 in one process through cli.run, both "
          "schedules against the unsharded grid; each planted fault breaks "
          "a bound")

    # ---- 9. backend='jnp' on the card ----
    t = time.perf_counter()
    backend_path(dev, card)
    phase("backend", t, "baseline 1 ran the plain path")

    # ---- 10. io: files, checkpoints and resume ----
    t = time.perf_counter()
    io_path(dev, card, steady_ms)
    phase("io", t, "#3 and #4 resumed bit for bit; each planted fault "
          "breaks its gate")

    # ---- 11. bench and profile on the card ----
    t = time.perf_counter()
    bench_path(dev, card, timing)
    phase("bench", t, "bench, --micro, --stability, --scaling, profile, "
          "the budget identities and Euler/RK4 on the card; every gate held")

    # ---- 12. the plain backend on #4's mesh ----
    t = time.perf_counter()
    jnp_mesh_path(noisy, dev, card)
    phase("jnp mesh", t, "#4 on backend=jnp on 2x4 in one process, "
          "shard_map and auto against the unsharded grid, no kernel launch; "
          "each planted fault breaks a bound")

    # ---- 13. the whole model: kernel path against plain path ----
    t = time.perf_counter()
    gate_path(dev, card)
    phase("gate", t, "#3 over 110 steps and #5 over 12, the kernel path "
          "within GATE_TOL of the plain path; each planted fault breaks a "
          "bound")

    # ---- 14. BASELINE #5 on the card ----
    t = time.perf_counter()
    b5 = baseline5_path(dev, card)
    phase("baseline5", t, "#5 unsharded for 0.25 days and on 4x8 in one "
          "process through cli.run, both schedules against the unsharded "
          "grid; the lat exchange left out breaks the bound")

    # ---- 15. the climate gates and 30 days over the continents ----
    t = time.perf_counter()
    clim = climate_path(dev, card)
    phase("climate", t, "the closure (both backends), equilibrium and "
          "fine-grid gates, the two kernels at their shapes, #2 for 500 "
          "steps and 30 days of #3 over the continents, each inside its "
          "bounds")

    # ---- 17. the compiled chunk against the eager loop ----
    t = time.perf_counter()
    compiled_path(dev, card)
    phase("compiled", t, "#3 over chunks of 100 steps with dt changes, #4 "
          "on 2x4 in both schedules, #5 unsharded and on 4x8: the compiled "
          "chunk equals the eager loop bit for bit, counted alike, with no "
          "capture after a dt change; each planted fault breaks it")

    # ---- 18. RK4 on the stage kernel ----
    t = time.perf_counter()
    rk4 = rk4_path(dev, card)
    phase("rk4", t, RK4_PHASE_MSG)

    # ---- 19. the ghost exchange's batched slab copy ----
    t = time.perf_counter()
    slab_copies = halo_copy_path(dev, card)
    phase("halo copy", t, "every pack, unpack, cut and splice of a rank of "
          "#5 on 2x2, float64, misaligned runs and more slabs than a launch "
          "takes: the batched copy equals the per-slab copies bit for bit, "
          "a launch for every 48 slabs")

    print("[across cards] not run: phase 16 runs only under --multicard, "
          f"on {MC_WORLD} cards (python3 chip_smoke.py --multicard)",
          flush=True)

    kernels = []
    # a corrector with the physics epilogue also runs fused_substep.cu's
    # launches; its source is the epilogue's
    for kname, (counter, path, ekey) in VARIANTS.items():
        epi = kname == "corrector_epilogue"
        launches = (main_counts if path == "packed scan"
                    else step_counts)[counter]
        kernels.append(kernel_entry(
            kname, "physics_epilogue.cu" if epi else "fused_substep.cu",
            path, launches, errs[ekey], EPI_TOL if epi else FIELD_TOL,
            timing[kname]))
    overlap_counts = sharded_counts["overlap"]
    for kname in shard_timing:
        epi = kname.startswith("corrector")
        kernels.append(kernel_entry(
            kname, "physics_epilogue.cu" if epi else "fused_substep.cu",
            "sharded packed scan", overlap_counts[kname], shard_errs[kname],
            SHARD_EPI_TOL if epi else SHARD_TOL, shard_timing[kname]))
    for kname in ("predictor_masked", "corrector_epilogue"):
        epi = kname == "corrector_epilogue"
        e = kernel_entry(kname,
                         "physics_epilogue.cu" if epi else "fused_substep.cu",
                         "packed scan, BASELINE #5 (1440x720x32)",
                         b5["counts"][kname], b5["errs"][kname],
                         EPI_TOL if epi else FIELD_TOL, b5["timing"][kname])
        kernels.append(dict(e, name=f"{e['name']}_baseline5"))
    for gate, ((nx, ny, nz), _, _) in CLIMATE_GATES.items():
        for kname in ("predictor_masked", "corrector_epilogue"):
            epi = kname == "corrector_epilogue"
            e = kernel_entry(kname,
                      "physics_epilogue.cu" if epi else "fused_substep.cu",
                      f"packed scan, the {gate} gate ({nx}x{ny}x{nz})",
                      clim["counts"][gate][kname], clim["errs"][gate][kname],
                      clim["tols"][gate] if epi else FIELD_TOL,
                      clim["timing"][gate][kname])
            kernels.append(dict(e, name=f"{e['name']}_{nx}x{ny}x{nz}"))
    # RK4 has no kernel in the JAX package: its plain step_rk4 is replaced
    rk4_run = "packed scan, BASELINE #3 with RK4 (compiled chunk)"
    for m in (1, 2, 3, 4):
        kernels.append(kernel_entry(
            f"rk4_stage{m}", "fused_substep.cu", rk4_run,
            rk4["counts"][f"rk4_stage_k{m}"], rk4["errs"][f"rk4_stage{m}"],
            RK4_TOL, rk4["timing"][f"rk4_stage{m}"], replaces=RK4_REPLACES))
    kernels.append(kernel_entry(
        "rk4_epilogue", "physics_epilogue.cu", rk4_run,
        rk4["counts"]["epilogue"], rk4["errs"]["rk4_epilogue"], EPI_TOL,
        rk4["timing"]["rk4_epilogue"], replaces=RK4_REPLACES))
    kernels += slab_copies
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(f"total {time.perf_counter() - T0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
