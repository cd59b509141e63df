#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (dedflow_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line each; the script exits non-zero at the first failure:
  1 card    nvidia-smi name and power limit, torch / CUDA versions
  2 build   nvcc builds the twelve kernel libraries from csrc/ (the
            solver's ten, the probes' two) in parallel (seconds, ptxas lines;
            the fused K1's and K2's and K11's registers and shared memory)
  lattice tier (box meshes):
  3 kernels at box_mesh(55, 55, 55) (998,250 tets), float32 on the card,
            K1-K3 each against its plain torch version on the same inputs
            (K1 and K2 one fused pass each, with their registers and shared
            memory), with times (CUDA events, after warm-up), K2 also
            unmasked (K2'); then F, J, SpMV and GMRES(120) times of the
            assembled system
  4 slice   one step_fixed(num_newton=2) at box_mesh(12, 12, 12): the card
            (float32, kernels) against the CPU (float64, plain versions)
  5 main    NSSolver(box_mesh(55, 55, 55), reference_scenario_config(),
            device="cuda").step twice, with the kernel launch counts
  windowed irregular (WinELL) tier:
  6 kernels at delaunay_mesh(56**3) + RCM (about 1.18M tets), float32:
            K6 (residual and Jacobian rows, the Jacobian also in its 33-row
            implicit mode), K7, K8 and K9 against their plain versions;
            the staged K6 (the solver's: the Jacobian straight into K9's
            staging rows, frozen and 33-row implicit) against its plain
            twin per block and against the column rows placed at the plan
            positions bit for bit, and K9's segment sum alone on those rows
            (equal to K9 over the column rows bit for bit); times, then F,
            J, SpMV and GMRES(120); the element input rows K10 gathers
            equal the index gather's bit for bit
  7 slice   the converted box 12 (lattice metadata dropped, RCM,
            use_lattice="winell", reference BCs with the Nitsche wall): one
            step_fixed(num_newton=2), card float32 against CPU float64
  8 main    NSSolver(that Delaunay mesh, reference_scenario_config(bcs=(),
            pin_pressure=True), device="cuda").step twice on the "winell"
            fastpath, with the launch counts of K6-K10 (the staged K6 and
            K9's segment sum; none of the column K6 or of K9's staging pass;
            K10's residual and Jacobian instances each by its own counter)
  coupled FEM-DEM step (DEM grid contact sweep K11 + the lattice tier):
  9 dem     K11 against its plain twin (bit for bit), float32, at bench.py's DEM cases
            (uniform_100k, settled_bed_100k: radius 0.006, 69**3 cells, K
            from the occupancy) and at the coupled scenario's grid, with
            pair slots/s and grid_run ms per substep over 10 substeps
 10 slice   CoupledSolver on box_mesh(12, 12, 12) with 200 particles, one
            step(num_newton=2): card float32 against CPU float64
 11 main    CoupledSolver(box_mesh(55, 55, 55), coupled_scenario_setup(mesh,
            num_particles=100_000), device="cuda").step twice, with the
            drag / fluid / DEM split and the launch counts of K1-K3 and K11
  general gather tier (K4, K5) and the windowed state gather (K10):
 12 kernels K4 and K5 (also in its implicit mode) at phase 6's Delaunay mesh
            in its generated (unordered) node order, on the solver of phase
            14, each also equal to K6 on the same inputs; K10 at phase 6's
            RCM mesh, node-major states in, bit for bit: the residual's
            48-row map with the geometry copied in (the (67, ne) K6 input),
            the same with a heat source, the 48 rows alone, and the
            Jacobian's 12-row map into rows 12-23 (library calls: one
            indexing of an (N, 14) node-major table, with the geometry's
            cat where the kernel copies it in; one indexing of w_alpha);
            K8 and K9 on the gather tier's plans (unordered sources)
            against their plain versions; the staged K5 (frozen and
            implicit) and K9's segment sum on the gather plan as in phase
            6; the staged K4 (the solver's residual: each pair's 6 rows
            straight into K8's staging rows, from node-major states)
            against its plain twin and against the column K4's rows at the
            plan positions bit for bit, and K8's segment sum alone on those
            rows (equal to K8 over the column rows bit for bit); times,
            bounds, the gather tier's F, J, SpMV and GMRES(120)
 13 slice   box 12 on use_lattice="gather" with the reference BCs and the
            Nitsche wall: one step_fixed(num_newton=2), card float32 against
            CPU float64
 14 main    NSSolver(the unordered Delaunay mesh, reference_scenario_config(
            bcs=(), pin_pressure=True, scatter_method="tiered",
            elements_kernel="pallas"), device="cuda") on fastpath "gather"
            (the "auto" ladder's floor) .step twice, with the launch counts of
            the staged K4, the staged K5, K7 and K8's and K9's segment sums
            (none of the column K4 / K5 or of K8's / K9's staging pass), and
            the device's busy share over one Newton iteration (torch.profiler);
            then phase 26 (b)'s reference (gather_perturbed_step)
  moving-laser melt pool (BASELINE config #3: implicit phi/T tangents and a
  heat source):
 15 kernels at box_mesh(44, 44, 44) (511,104 tets), melt_pool_scenario_config():
            K1 with the laser source, K2 in its implicit mode (data per
            vel/p block, scal per component) and K6 in its 33-row mode on the
            lattice's slab-major (6, 33, N) inputs, each against its plain
            version, with times and bounds; then F, J + PC, SpMV and
            GMRES(120) of the melt system
 16 slice   box 12 on the lattice, on the converted box with RCM
            (use_lattice="winell") and on use_lattice="gather": one
            step_fixed(num_newton=2, source=the laser) each, card float32
            against CPU float64, with each tier's launch counts (the WinELL
            and gather tiers through the staged K6 / K5 and K9's segment sum,
            the gather tier's residual through the staged K4 and K8's)
 17 main    NSSolver(box_mesh(44, 44, 44), melt_pool_scenario_config(),
            device="cuda"): two adaptive steps with the laser source, then
            three step_fixed(2) (tools/melt_bench.py's run), with s/step,
            Newton and Krylov counts, t_max, peak memory and the launch
            counts of K1-K3; the hottest node within 3 laser radii of the
            beam's mid-run centre; step 1 repeated bit-identical; the
            device's busy share over one step_fixed(2) (torch.profiler)
  probes of the irregular tier's primitives (dedflow_tpu_torch.tools, no
  main path):
 18 probes  K12 (tools/gmicro.py's eleven variants: copy, the lane gather by
            warp shuffles and by shared memory, the window gather for nwin
            1, 2, 4 and the one-hot row, the segment reduce for hb 16, 8, 4,
            1) on the (8, 2**23) stream, and K13 (the element gather, global
            and staged) at W = 4096, 65,536 elements: each kernel against its
            plain version (copies and gathers bit for bit, the reduce within
            TOL_K12_REDUCE; the window gathers and the reduce also on ids
            over their full range) and its library call; the reduce (rows,
            then bins) at hb 1, 2, 4, 8 and 16 on both id sets; then the
            probes' own path, their entry points' runs (gmicro.run,
            gather_probe.run), with the launch counts of the five probe
            wrappers
  the Krylov options (ROADMAP A11: pc "simple" / "mg", precision "f64" /
  "ir", the lagged Jacobian):
 19 krylov  box 55, reference scenario: one adaptive step for each pc
            (fieldsplit, simple, mg) with Newton and Krylov counts, s/step,
            peak memory and the launch counts of K1-K3, the preconditioner's
            set-up ms and one apply's ms (as the host paces it and queued on
            the card) and device operations (torch.profiler); the mg step
            repeated bit-identical; then precision "ir" (pc mg) as one
            step_fixed(1), with its refinement cycles, inner iterations and
            final relative linear residual, and K3's float64 mode on that
            mesh's J against its plain version (TOL_F64) and an f64 CSR
            product. Phase 6's RCM mesh with pc mg (AMG): the plan's host
            set-up s, one adaptive step repeated bit-identical, the PC's
            set-up and apply, step_fixed(1) with "ir" on the same contexts,
            and K7's float64 mode on its J. Phase 12's unordered mesh on the
            gather tier with pc simple: one adaptive step and its PC. Box 12,
            card float32 against CPU float64, step_fixed(2): pc simple and
            mg on the lattice, AMG on the converted box (WinELL), simple on
            the gather tier, the lagged Jacobian, and "ir", whose refined
            solves must reach 1e-10
  mesh files and the translation-class tier (ROADMAP A10: any table of up
  to 8 slabs; K1c / K2c in one pass where the table places on a node grid,
  csrc/lattice_residual.cu and csrc/lattice_jacobian.cu, their two-pass
  entries in csrc/lattice_classes.cu):
 20 classes box 55 as (a) the deformed box without lattice metadata
            (mesh.gen.deformed_mesh: the classes tier) and (b) a shuffled,
            mirrored copy (mesh.gen.shuffled_mesh) recovered by
            recover_lattice (the lattice tier with another split; the
            recovery's host seconds on their own): the one-pass K1c and K2c
            (frozen, masked and unmasked) and the two-pass entries against
            their plain versions per equation / vel/p block, with times and
            bounds, the two routes timed in turns, ptxas registers and spill
            bytes, and one adaptive step of each (s/step, counts, peak
            memory, set-up s; the one-pass K1c, K2c and K3 launched, the
            fused K1 / K2 and the two-pass entries not); K3 on a synthetic
            27-plane matrix (float32 and float64) against its plain version
            and a CSR product; P1': the Kuhn box 55 and the melt box 44 with
            its source through the one-pass K1c / K2c on their own table, in
            turns with the ticketed K1 (bit for bit) and the fused K2; K2c
            implicit at the melt box, both routes, in turns; box-12 slices,
            one adaptive step each, card float32 against CPU float64 with
            equal Newton counts and Krylov counts equal or witnessed by
            plain float32 steps on the CPU: (a), (b), the L-shaped part of
            the box (mesh.gen.l_shaped_mesh), the melt pool on (a) (K2c
            implicit's launches), pc "mg" on (a), and a kernel check on a
            non-conforming stress mesh with 8 classes and 21 DIA planes
            (overlaid_mesh: K3's launches past 15 planes); the two-pass
            entries' launches 0 on every slice
  the CLI's run outputs (ROADMAP A17b):
 21 run     app.main.main at box 55, reference scenario, --steps 2
            --save-every 1 --metrics --profile: the solution files go to an
            in-memory store of io.h5.solution_datasets where h5py does not
            import (the card machine has none), real HDF5 files where it
            does (the line says which); exit code 0, two metrics records
            with the JAX CLI's keys, the step-2 snapshot equal bit for bit
            to phase 5's state after the same two steps, the profiler trace
            naming K1-K3's CUDA kernels; --resume 1 --steps 1 equal bit for
            bit to NSSolver.step from the snapshot's reconstruction (dwgold
            = dwg); the coupled scenario at box 12 with 200 particles
            storing particles.1, equal bit for bit to a direct
            CoupledSolver step; the snapshot's host cost (ms) and the steps'
            walls with the trace on against phase 5's without it
  the scalar heat / Poisson slice (ROADMAP A12, BASELINE config #1:
  -lap(u) = 3 pi^2 sin(pi x) sin(pi y) sin(pi z), u = 0 on the six faces):
 22 heat    Jacobi-preconditioned CG (rtol 1e-6, float32) at box 12, card
            against the CPU's float64 solve; box 15 (20,250 tets) and box
            55 (the main path, K8 / K9 launches read around it): set-up s,
            assembly ms (fem.heat.assemble_poisson + the Dirichlet rows),
            CG and GMRES(120) + Jacobi iterations, solve s and L2 error
            against the exact solution, each solve run twice with equal
            counts; K8 and K9 with one output row on the box-55 Poisson
            plans against their plain versions, timed, with bounds and an
            index_add
  mixed prism / hex meshes (ROADMAP A13: the cells' stencils enter the
  matrix pattern, the tets are assembled):
 23 mixed   (a) box 12 with a hex over every cube and two prisms over each
            cube of the lowest layer, on the tier the JAX ladder picks
            (WinELL: the 27-point stencil leaves the lattice's): one
            step_fixed(num_newton=2), card float32 against CPU float64;
            (b) box 55 with a hex table over its 166,375 cubes (998,250
            tets, 27 node blocks a row): K10, K6's residual rows, the staged
            K6, K8, K9's segment sum and K7 on the 27-wide rows against
            their plain versions as phase 6 holds them, timed with bounds
            and library calls; K10's residual also with the elements sorted
            by minimum node, in Morton order and shuffled; then
            NSSolver.step twice (and step 1
            repeated bit-identical) with set-up s, s/step, Newton and
            Krylov counts, peak memory and each kernel's launches
  the check tools (ROADMAP A18, dedflow_tpu_torch/tools):
 24 checks  residual_check at n = 15 (float64 GMRES through K3's float64
            mode and "ir", both relative residuals <= 1e-10), selfcheck
            (K1, K2, K2' against their plain versions at box_mesh(8, 6, 7)),
            nonlinear_f64_check at box 24 (the card's float32 steps, "ir"
            and "state", against the CPU's float64 step)
  the multi-device path (ROADMAP A16: parallel.sharded, a box cut into
  z-slabs over torch.distributed ranks; one card, so the ranks share it
  through gloo, every exchange staged through pinned host memory):
 25 sharded (a) box 12 on 2 and 4 ranks, one adaptive step each against the
            CPU float64 one-process step (TOL_SLICE, equal Newton counts,
            Krylov counts equal or witnessed); (b) box 55 on 2 ranks, one
            step from the reference initial state against phase 5's first
            (each field within TOL_SLICE, equal Newton counts), with s/step
            and its split (kernels, bands and carries, all-reduces, the
            rest), each rank's launches of K1, K2 and K3's banded entry
            (every one > 0, the plain twins never called), peak memory,
            halo bytes a Newton iteration and all-reduces a Krylov
            iteration; (c) each rank's slab K1, K2 (masked and unmasked) and
            banded K3 (masked and unmasked) against their plain twins, timed
            on rank 0 with bounds and a CSR product (3 kernel rows tagged
            "slab, box-55 half"); (d) dryrun_multichip(2) on the card and
            app.main --devices 2 at box (4, 3, 6)
 26 rcb     the RCB mode (any tet mesh RCB-partitioned onto the gather tier,
            each rank's local submesh with its ghosts): (a) delaunay_mesh(500,
            seed=7) on 2 and 4 ranks, one adaptive step each from
            perturbed_state and from perturbed_flow_state against the CPU
            float64 one-process gather step and a one-process card step on
            the same input (the bar TOL_SLICE, or twice a plain float32 CPU
            step's distance from float64 where that is larger: 2.2e-3 from
            perturbed_state, whose small fields are float32 noise; equal
            Newton counts, Krylov counts equal or witnessed); (b) phase 14's
            Delaunay mesh, 1,181,683 tets in generated order, on 2 ranks at
            perturbed_flow_state against phase 14's one-process solver: F,
            J x (the halo exchange and K7's halo entry) and the field-split
            apply, each field within TOL_SLICE; one step, equal Newton and
            Krylov counts, each field within RCB_WITNESS_FACTOR times the
            distance float32 roundoff of the input alone moves the
            one-process step (GMRES stalls at its 120 cap there), with
            its split (kernels, halo exchanges, all-reduces, staging),
            ghosts, bytes per exchange, peak memory and each rank's
            launches of the staged K4 / K5, K7's halo entry and K8's / K9's
            segment sums (every one > 0; their plain twins, the whole-matrix
            K7 and the column K4 / K5 never); (c) each rank's part kernels
            against their plain twins and the column kernels' route, timed
            on rank 0 with bounds, a CSR product and index_add (5 kernel rows
            tagged "RCB part, Delaunay half"); (d) the melt pool on box 12
            (gather) on 2 ranks, as (a); (e) app.main --devices 2 --mesh on a
            shuffled box's file read without lattice recovery (an .npz: the
            card machine has no h5py) against a one-process card step
  the coupled FEM-DEM step on ranks (ROADMAP A16 (c): the fluid on z-slabs,
  each particle's drag computed by the rank that owns its element, the DEM
  on cell slabs of the flat cell axis through K11's halo entry):
 27 coupled sharded
            (a) phase 11's main path (box 55, 100,000 particles) on 2
            gloo ranks sharing the card, one adaptive step from the reference
            initial state against phase 11's first: the particles bit for
            bit, each fluid field within TOL_SLICE, equal Newton counts;
            each rank's launches of K1, K2, K3's banded entry and K11's halo
            entry (> 0; the whole-grid K11 and every plain twin never), the
            drag / fluid / DEM split, the fluid's and the DEM's band
            exchanges, bytes and all-reduces, peak memory; (b) K11's halo
            entry on each rank's window against its plain twin, bit for bit,
            timed on rank 0 with its bound (one kernel row); (c) app.main
            --scenario coupled --devices 2 at box 12 against a one-process
            card CoupledSolver step (particles.1 bit for bit, sol.1 within
            TOL_SLICE)
Then, on lines of their own: the kernels JSON object (each kernel with its
time, its plain version's, its bound and, where one PyTorch call computes
the same function, that call's time), the card's name and power limit, and
last {"ok": true, "device": {...}}. Without CUDA, or without the
dedflow_tpu_torch package beside it, it fails and prints no result. It
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import sys
import time
import traceback

FULL_BOX = (55, 55, 55)
MELT_BOX = (44, 44, 44)  # BASELINE config #3, MELT_TPU.json: 511,104 tets, 91,125 nodes
MELT_STEPS, MELT_FIXED_NEWTON = (2, 3), 2  # adaptive, then step_fixed(2) (tools/melt_bench.py)
SLICE_BOX = (12, 12, 12)
DELAUNAY_POINTS = 56**3  # 175,616 points, about 1.18M tets (bench.py:117,126)
SEED = 0
COUPLED_PARTICLES = 100_000  # COUPLED_TPU.json, the JAX package's coupled record
SLICE_PARTICLES, SLICE_RADIUS = 200, 0.02
DEM_RADIUS, DEM_SUBSTEPS = 0.006, 10  # bench.py:512-513

# Tolerances, relative = max|kernel - plain| / max|plain|, float32 on the card.
# The kernels and their plain versions sum in different orders and the
# kernels use the hardware rsqrtf/sqrtf: float32 roundoff, amplified by
# the cancellation in sums of element contributions.
TOL_K1 = 2e-5  # the JAX package's own fused-vs-unfused bar (lattice.py:749)
TOL_K2 = 2e-5
TOL_K3 = 1e-5  # 60 products per output row, no cancellation-heavy terms
TOL_K6 = 2e-5  # the element bodies of K1/K2 on element columns
TOL_K7 = 1e-5  # about 16 entries x 4 products per output row
# K7's product (float32, float64) holds two entries' loads in flight in
# these registers (csrc/winell_spmv.cu, schedule_fence); ptxas's other
# schedule, loads interleaved with the FMAs in 40 / 64, runs 9-28% slower
K7_REGISTERS = (64, 124)
TOL_K8 = 1e-5  # 4 to 40 contributions per node, one add each
TOL_K9 = 1e-5  # about 6.6 contributions per entry
# K11 adds each centre's pair terms in its plain twin's order with IEEE
# float32 ops and no contraction: it must equal the plain twin bit for bit.
TOL_K11 = 0.0
TOL_K4 = 2e-5  # K6's residual body on gathered states
TOL_K5 = 2e-5  # K6's Jacobian body, per vel/p block and per phi/T tangent
# K10 copies: it must equal its plain version bit for bit.
# The 16 velocity/pressure components of a nodal block, by sub-block, in
# the element Jacobian's packed order (K6 rows ab*18+c). Their scales
# differ by orders of magnitude (the pressure rows are far smaller than the
# velocity block), so the Jacobian's kernels are held to their tolerance
# block by block, each against its own scale, as the products and
# residuals are equation by equation.
VP_BLOCKS = {"uu": range(0, 9), "up": range(9, 12), "pu": range(12, 15), "pp": range(15, 16)}
# Components 16, 17: the frozen phi/T identities (exact), or the implicit
# phi/T tangents, each on its own scale.
IDENTITY_BLOCKS = {"phi,T identities": [16, 17]}
SCALAR_BLOCKS = {"phi tangent": [16], "T tangent": [17]}
# Slice phase: a float32 GMRES stopped at rtol 1e-4 against a float64 one.
# Each Newton update is accurate to about 1e-4 of its own size and the
# second update corrects most of the first one's error, so the new states
# agree to about 1e-5 of their size or better (2.6e-6 measured on an H100).
TOL_SLICE = 1e-4
# Coupled slice, particles: positions are O(1) and move by under 1e-3 in a
# step, so float32 keeps them to ~1e-7 of their size; velocities (~0.1)
# come from contact forces k_n * delta whose delta carries the float32
# error of the distances (~4e-9 of 0.05), i.e. ~1e-6 of their size after
# 10 substeps, plus the fluid's TOL_SLICE in the drag. 1e-4 relative
# covers both with margin. Only while no pair crosses delta = 0 in the
# step: a contact that switches on in one precision and not the other adds
# the jump gamma_n * v_n, so the slice's cloud is chosen for its widest
# margin and checked (phase_coupled_slice).
TOL_PARTICLES = 1e-4

# K12's segment reduce sums each column's 8 rows, then adds the 512 column
# sums of a block into its 128 bins through warp sums and shared-memory
# atomics, in an order that changes from run to run; the plain version
# sums the rows, then the columns in order. What may differ is float32
# roundoff of sums of at most 512 column sums a bin, relative to the
# largest sum. Its copies and gathers only move values: bit for bit.
TOL_K12_REDUCE = 1e-5
REDUCE_HBS = (1, 2, 4, 8, 16)  # the segment reduce's hb, each held against its plain twin
PROBE_N = 1 << 23  # tools/gmicro.py's lanes a row
PROBE_W = 4096  # tools/gather_probe.py's window

# The TPU kernels the three CUDA kernels replace (file:line of the kernel).
KERNELS = (
    ("K1 lattice residual", "dedflow_tpu_torch/csrc/lattice_residual.cu",
     "dedflow_tpu/fem/lattice.py:779"),
    ("K2 lattice jacobian", "dedflow_tpu_torch/csrc/lattice_jacobian.cu",
     "dedflow_tpu/fem/lattice.py:835"),
    ("K3 dia spmv", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:56"),
)
DEM_KERNELS = (
    ("K11 dem contact sweep", "dedflow_tpu_torch/csrc/dem_contact.cu",
     "dedflow_tpu/dem/grid.py:221"),
)
GATHER_KERNELS = (
    ("K4 gathered element residual", "dedflow_tpu_torch/csrc/gather_elements.cu",
     "dedflow_tpu/fem/pallas_kernels.py:434"),
    ("K5 gathered element jacobian", "dedflow_tpu_torch/csrc/gather_elements.cu",
     "dedflow_tpu/fem/pallas_kernels.py:507"),
    ("K10 win gather (residual rows)", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
    ("K10 win gather (jacobian rows)", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
    ("K8 stream reduce (gather plan)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
    ("K9 ring reduce (gather plan)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
)
# K7 on the gather tier's matrix: the same tets as IRREGULAR_KERNELS' K7 in
# their generated node order (phase 12's record, phase 14's launches)
GATHER_SPMV_KERNELS = (
    ("K7 winell spmv (gather matrix, generated order)", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:55"),
)
# K10's instances beside GATHER_KERNELS' two, on the same RCM mesh: the
# residual map with the heat source (the melt pool's WinELL residual) and
# the residual map alone, the 48 rows without the geometry copy (the
# function the former kernel computed from a (14, N) table; on no path)
K10_KERNELS = (
    ("K10 win gather (residual rows, heat source)", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
    ("K10 win gather (residual map alone, no geometry)", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
)
GATHER_CONFIG = dict(bcs=(), pin_pressure=True, scatter_method="tiered",
                     elements_kernel="pallas")  # bench.py:133-151's Delaunay settings
# The melt pool's kernel modes. The JAX package runs the lattice's implicit
# Jacobian through the 33-row K6 (pallas_kernels.py:544, slab-major) and an
# XLA reduce; here K2 computes that matrix. It computes the gather tier's in
# XLA (ns.py:184-235); here K5 does.
MELT_KERNELS = (
    ("K1 lattice residual (heat source)", "dedflow_tpu_torch/csrc/lattice_residual.cu",
     "dedflow_tpu/fem/lattice.py:779"),
    ("K2 lattice jacobian (implicit phi/T)", "dedflow_tpu_torch/csrc/lattice_jacobian.cu",
     "dedflow_tpu/fem/pallas_kernels.py:544"),
    ("K6 element rows (jacobian, 33-row implicit)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:544"),
    ("K5 gathered element jacobian (implicit phi/T)", "dedflow_tpu_torch/csrc/gather_elements.cu",
     "dedflow_tpu/fem/pallas_kernels.py:507"),
)
# The irregular tiers' Jacobian path: the staged K6 / K5 store each
# element's 16 vel/p contributions (and, implicit, its phi/T tangents)
# straight into K9's staging rows at their plan positions, and K9's segment
# sum alone adds them up. The column entries above (K6 / K5 Jacobian rows,
# K9 with its staging pass) stay the counterparts of the JAX kernels and run
# on no solver path: their launches on the main paths are 0.
STAGED_KERNELS = (
    ("K6 element rows staged (jacobian)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K6 element rows staged (jacobian, 33-row implicit)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:544"),
    ("K9 segment sum (WinELL plan)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
    ("K5 gathered element jacobian staged", "dedflow_tpu_torch/csrc/gather_elements.cu",
     "dedflow_tpu/fem/pallas_kernels.py:507"),
    ("K5 gathered element jacobian staged (implicit phi/T)",
     "dedflow_tpu_torch/csrc/gather_elements.cu", "dedflow_tpu/fem/pallas_kernels.py:507"),
    ("K9 segment sum (gather plan)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
)
# The gather tier's residual path: the staged K4 stores each
# (element, vertex) pair's 6 components straight into K8's (K, 8) staging
# rows at their plan positions, and K8's segment sum alone adds them up. The
# column K4 and K8 with its staging pass (GATHER_KERNELS) run on no path of
# that tier: their launches on its main path are 0.
RESIDUAL_STAGED_KERNELS = (
    ("K4 gathered element residual staged", "dedflow_tpu_torch/csrc/gather_elements.cu",
     "dedflow_tpu/fem/pallas_kernels.py:434"),
    ("K8 segment sum (gather residual plan)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
)
IRREGULAR_KERNELS = (
    ("K6 element rows (residual)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K6 element rows (jacobian)", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K7 winell spmv", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:55"),
    ("K8 stream reduce", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
    ("K9 ring reduce", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
)


class PhaseError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, ref) -> tuple[float, float]:
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    return err, err / max(scale, 1e-300)


def alternate_ms(kernel, plain, reps_k: int, reps_p: int) -> tuple[float, float]:
    """Kernel and plain timed in turns (plain, kernel, kernel, plain)."""
    from dedflow_tpu_torch.tools.timing import time_ms

    p1 = time_ms(plain, reps_p)
    k1 = time_ms(kernel, reps_k)
    k2 = time_ms(kernel, reps_k)
    p2 = time_ms(plain, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(name: str, err_rel: float, tol: float) -> None:
    if not err_rel <= tol:  # also catches NaN
        raise PhaseError(f"{name}: relative error {err_rel:.3e} above {tol:.1e}")


# Operation counting for the bounds: the plain version of a kernel runs
# under a dispatch mode that adds up the arithmetic it asks for, by aten op:
# an elementwise op counts its output elements, a reduction or an
# accumulating scatter its inputs, a matrix product 2*m*n*k. Copies,
# gathers, padding and allocation count nothing.
ELEMENTWISE_OPS = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt", "rsqrt", "reciprocal",
    "pow", "exp", "log", "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
    "gt", "lt", "ge", "le", "eq", "ne", "where", "sign", "addcmul", "addcdiv",
    "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_not", "masked_fill", "lerp",
}
REDUCING_OPS = {"sum": 0, "mean": 0, "amax": 0, "amin": 0, "prod": 0,
                "index_add": 3, "scatter_add": 3}  # op -> counted arg
PRODUCT_OPS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}


def op_count(fn) -> tuple[int, list]:
    """(operations the call asks for, names of the aten ops not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n, self.skipped = 0, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ELEMENTWISE_OPS:
                self.n += out.numel()
            elif name in REDUCING_OPS:
                arg = args[REDUCING_OPS[name]]
                self.n += arg.numel() if hasattr(arg, "numel") else 0
            elif name in PRODUCT_OPS:
                a, b = [t for t in args if hasattr(t, "shape")][-2:]
                self.n += 2 * a.numel() * (b.shape[-1] if b.dim() > 1 else 1)
            else:
                self.skipped.add(name)
            return out

    with Count() as c:
        fn()
    return c.n, sorted(c.skipped)


def finish(label: str, rec: dict, kernel, plain, reps: int, plain_reps: int,
           nbytes_: float, counted: tuple, library=None, ops_per_s=None) -> dict:
    """Time a checked kernel against its plain version (and the library
    call, where one exists), add its bound from the bytes and the
    (operations, ops not counted) of op_count, at the FP32 rate unless
    `ops_per_s` gives another; print one line."""
    import torch

    from dedflow_tpu_torch.tools.timing import FP32_OPS_PER_S, bound, time_ms

    rec["ms"], rec["plain_ms"] = alternate_ms(kernel, plain, reps, plain_reps)
    ops, skipped = counted
    rec["bound_ms"], rec["bound_by"] = bound(nbytes_, ops, ops_per_s or FP32_OPS_PER_S)
    rec["library_ms"] = None
    if library is not None:
        call, check_against = library
        got = call()
        torch.cuda.synchronize()
        _, lib_rel = rel_err(got.reshape(check_against.shape), check_against)
        rec["library_ms"] = time_ms(call, max(reps // 2, 3))
        say(f"  {label}: library call vs kernel rel={lib_rel:.3e}")
    say(f"  {label}: ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}: {nbytes_ / 1e6:.1f} MB, "
        f"{ops / 1e9:.3f} Gop) library_ms={rec['library_ms']}"
        + (f" [ops not counted: {','.join(skipped)}]" if skipped else ""))
    return rec


def block_csr(n: int, pieces, cols: int | None = None):
    """The 6N x 6N matrix (6N x 6 cols with `cols`), component-major (row
    b*N + node, column b*cols + node), of `pieces`: (row nodes, col nodes,
    {packed component: values}) triples, as one torch.sparse CSR tensor
    (the library yardstick of the SpMVs)."""
    import torch

    from dedflow_tpu_torch.sparse.fsbsr import COMP_SLOTS

    m = n if cols is None else cols
    rows, cix, vals = [], [], []
    for r, c, by_comp in pieces:
        for comp, bi, bj in COMP_SLOTS:
            rows.append(bi * n + r)
            cix.append(bj * m + c)
            vals.append(by_comp[comp])
    idx = torch.stack([torch.cat(rows), torch.cat(cix)])
    coo = torch.sparse_coo_tensor(idx, torch.cat(vals), (6 * n, 6 * m))
    return coo.coalesce().to_sparse_csr()


def index_add_call(plan, x, comps, cstride):
    """One torch.index_add over the plan's contributions (gathered once
    beforehand): the library yardstick of the segmented reduces."""
    import torch

    tgt = torch.repeat_interleave(torch.diff(plan.ptr.long()))
    src = plan.src.long()
    flat = x.reshape(-1)
    vals = torch.stack([flat[src + c * cstride] for c in comps])
    zeros = torch.zeros((len(comps), plan.num_tgt), dtype=x.dtype, device=x.device)
    return lambda: torch.index_add(zeros, 1, tgt, vals)


def reduce_parts() -> tuple[dict, dict]:
    """{name: view} of the node reduce's rows by equation and of the entry
    reduce's WinELL rows by vel/p block: each is checked against its own
    scale."""
    from dedflow_tpu_torch.sparse.winell import COMP2WIN

    by_eq = {" [u rows]": lambda t: t[:3], " [p row]": lambda t: t[3:4],
             " [phi,T rows]": lambda t: t[4:]}
    entry_blocks = {f" [{b}]": (lambda t, r=[int(COMP2WIN[c]) for c in cs]: t[r])
                    for b, cs in VP_BLOCKS.items()}
    return by_eq, entry_blocks


def reduce_bytes(plan, comps, out_rows: int) -> int:
    """Bytes a segmented reduce must move: the plan, one float per
    contribution and row, the output."""
    from dedflow_tpu_torch.tools.timing import nbytes

    k = plan.src.numel()
    return nbytes(plan.ptr, plan.src) + 4 * k * len(comps) + 4 * out_rows * plan.num_tgt


def jacobian_blocks(m: int, implicit: bool, slabs: int = 0) -> dict:
    """{name: view} of (288, m) (or (slabs, 288, m)) element Jacobian rows
    ab*18+c by vel/p block, then the phi/T identities or tangents."""
    shape = (slabs, 16, 18, m) if slabs else (16, 18, m)
    blocks = dict(VP_BLOCKS, **(SCALAR_BLOCKS if implicit else IDENTITY_BLOCKS))
    return {f" [{b}]": (lambda t, c=list(cs): t.reshape(shape)[..., c, :])
            for b, cs in blocks.items()}


def staged_pack(out):
    """The staged kernels' (K, 16) rows and, implicit, (K, 8) tangents as
    one (K, 16 | 24) tensor."""
    import torch

    stage, tang = out
    return stage if tang is None else torch.cat([stage, tang], 1)


def staged_blocks(implicit: bool) -> dict:
    """{name: view} of packed staging rows by vel/p block (columns in
    WinELL row order), then the phi/T tangents and their zero padding."""
    from dedflow_tpu_torch.sparse.winell import COMP2WIN

    parts = {f" [{b}]": (lambda t, c=[int(COMP2WIN[k]) for k in cs]: t[:, c])
             for b, cs in VP_BLOCKS.items()}
    if implicit:
        parts.update({" [phi tangent]": lambda t: t[:, 16], " [T tangent]": lambda t: t[:, 17],
                      " [tangent padding]": lambda t: t[:, 18:]})
    return parts


def staged_record(label: str, plan, kern, plain, column, implicit: bool, tol: float,
                  in_bytes: int, reps: int) -> tuple[dict, object]:
    """A staged element kernel (outputs (K, 16) and, implicit, (K, 8))
    against its plain twin per block and against the column kernel's rows
    placed at the plan positions (`column`: element_kernels.stage_rows of
    them) bit for bit; its record as finish() makes it, and its output."""
    import torch

    from dedflow_tpu_torch.tools.timing import nbytes

    err = compare(label, lambda: staged_pack(kern()), lambda: staged_pack(plain()), tol,
                  parts=staged_blocks(implicit))
    got, ref = staged_pack(kern()), staged_pack(column())
    same = torch.equal(got, ref)
    say(f"  {label} == the column kernel's rows at the plan positions, bit for bit: {same}")
    if not same:
        raise PhaseError(f"{label}: the staged rows differ from the column kernel's")
    del ref
    # the function's output: 16 floats a contribution and, implicit, its 2
    # tangents; the (K, 8) buffer's 6 zeros a row are the layout's cost
    rec = finish(label, {"max_abs_err": err}, kern, plain, reps, 3,
                 in_bytes + nbytes(plan.elem_pos, got[:, :18]), op_count(plain))
    return rec, kern()


def segment_sum_record(label: str, plan, stage, ring_out, reps: int,
                       residual: bool = False) -> dict:
    """The segment sum alone over the staging rows `stage`: K9's over (K, 16)
    rows (per vel/p block, TOL_K9), or with `residual` K8's over the (K, 8)
    residual rows (6 rows, per equation, TOL_K8). Against its plain twin,
    equal bit for bit to `ring_out` (K9 / K8 with its staging pass over the
    column rows of the same values), timed against the plain twin and an
    index_add of the rows."""
    import torch

    from dedflow_tpu_torch.sparse.win_ring import ring_reduce_staged, ring_reduce_staged_plain
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce_staged, stream_reduce_staged_plain
    from dedflow_tpu_torch.tools.timing import nbytes

    rows, (kfn, pfn), tol, parts = (
        (6, (stream_reduce_staged, stream_reduce_staged_plain), TOL_K8, reduce_parts()[0])
        if residual else
        (16, (ring_reduce_staged, ring_reduce_staged_plain), TOL_K9, reduce_parts()[1]))
    kern = lambda: kfn(plan, stage, rows)
    plain = lambda: pfn(plan, stage, rows)
    err = compare(label, kern, plain, tol, parts=parts)
    same = torch.equal(kern(), ring_out)
    what = "K8" if residual else "K9"
    say(f"  {label} == {what} with its staging pass over the column rows, bit for bit: {same}")
    if not same:
        raise PhaseError(f"{label}: not equal to {what} over the column rows")
    tgt = torch.repeat_interleave(torch.diff(plan.ptr.long()))
    zeros = torch.zeros((plan.num_tgt, stage.shape[1]), dtype=stage.dtype, device=stage.device)
    out = torch.empty((rows, plan.num_tgt), dtype=torch.float32)
    # the function sums `rows` floats a contribution: the residual rows' 2
    # zero floats are the layout's cost, not the function's bytes
    return finish(label, {"max_abs_err": err}, kern, plain, reps, 3,
                  nbytes(plan.ptr, stage[:, :rows], out), op_count(plain),
                  library=(lambda: torch.index_add(zeros, 0, tgt, stage).T[:rows], kern()))


def perturbed_flow_state(mesh, device, dtype):
    """perturbed_state with a smooth seeded velocity and pressure added to
    wgold and dwgold (0.1 sin(2 pi k . x + phi) a component): the step's
    every field then has a scale of its own, not the float32 noise of a
    uniform flow."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 1)
    xg = np.asarray(mesh.xg, dtype=np.float64)
    wg, dwgold, dwg = perturbed_state(mesh, device, dtype)

    def smooth(t):
        k, phi = rng.integers(1, 4, size=(3, 4)), rng.uniform(0, 2 * np.pi, size=4)
        wave = np.zeros(tuple(t.shape))
        wave[:, :4] = 0.1 * np.sin(2 * np.pi * xg @ k + phi)
        return torch.as_tensor(wave, dtype=dtype, device=t.device)

    return wg + smooth(wg), dwgold + smooth(dwgold), dwg


def perturbed_state(mesh, device, dtype):
    """Reference initial state with a seeded perturbation of dwg (so every
    input row of the element bodies is non-zero), advanced by one predict
    (tools/selfcheck.py's state)."""
    from dedflow_tpu_torch.tools import selfcheck

    return selfcheck.perturbed_state(mesh, device, dtype, SEED)


def phase_build() -> None:
    from dedflow_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    libs = nvcc.load([
        "lattice_residual", "lattice_jacobian", "dia_spmv",
        "element_rows", "winell_spmv", "seg_reduce", "dem_contact",
        "gather_elements", "win_gather", "gmicro", "gather_probe", "lattice_classes",
    ])
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(libs)} libraries (nvcc {nvcc.nvcc_path()})")
    for lib in libs.values():
        say(f"  {lib.name}: {lib.build_seconds:.2f} s")
        for ln in lib.ptxas:
            say(f"    {ln}")
    from dedflow_tpu_torch.fem.lattice import fused_kernel_layout, residual_kernel_layout

    # the fused K2 stages a round's slabs x 16 pairs x a component group on
    # the tile's halo cells in dynamic shared memory (as the kernel reports it)
    stage = {m: fused_kernel_layout(m)["stage_bytes"] for m in (False, True)}
    jac, dem = libs["lattice_jacobian"], libs["dem_contact"]
    k1_regs = registers(libs["lattice_residual"], "residual_fused_kernel", "KuhnCells")
    say(f"  K1 fused pass: registers {k1_regs}; tiling {residual_kernel_layout()}")
    k2_regs = [registers(jac, f"jacobian_fused_kernelILb{m}E", "KuhnPlanes") for m in (0, 1)]
    say(f"  K2 fused pass: registers frozen {k2_regs[0]}, "
        f"implicit {k2_regs[1]}; dynamic shared memory "
        f"frozen {stage[False]} B, implicit {stage[True]} B")
    say(f"  K3 registers, float32 and float64 instances: "
        f"{registers(libs['dia_spmv'], 'dia_spmv_kernelIfE')}, "
        f"{registers(libs['dia_spmv'], 'dia_spmv_kernelIdE')}")
    spmv = libs["winell_spmv"]
    k7_regs = tuple(registers(spmv, f"winell_spmv_kernelI{t}E") for t in "fd")
    say(f"  K7 registers, float32 / float64: product {k7_regs[0]} / {k7_regs[1]}, "
        f"node-major pass {registers(spmv, 'node_major_kernelIfE')} / "
        f"{registers(spmv, 'node_major_kernelIdE')}")
    if k7_regs != K7_REGISTERS:
        raise PhaseError(f"K7's product takes {k7_regs} registers, not {K7_REGISTERS}: ptxas "
                         "changed its schedule (csrc/winell_spmv.cu, schedule_fence)")
    say("  K11 sweep: registers by capacity K (0: any K) "
        + ", ".join(f"{k}: {registers(dem, f'dem_contact_kernelILi{k}E')}" for k in range(13)
                    if k != 1))


def compare(label: str, kernel, plain, tol: float, parts=None) -> float:
    """Run a kernel twice and its plain version once on the same inputs;
    check that the two kernel runs are bit-identical (no atomics: results
    repeat from run to run) and print and check the relative error;
    return the max abs error. `parts` {name: view} checks each view of the
    output against its own scale (for outputs whose parts differ in size
    by orders of magnitude)."""
    import torch

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise PhaseError(f"{label}: non-finite kernel output")
    if not torch.equal(got, again):
        raise PhaseError(f"{label}: two runs of the kernel differ")
    worst, rels = 0.0, {}
    for name, view in (parts or {"": lambda t: t}).items():
        err, rels[name] = rel_err(view(got), view(ref))
        say(f"  {label}{name}: max_abs_err={err:.3e} rel={rels[name]:.3e} (tol {tol:.0e})")
        worst = max(worst, err)
    for name, rel in rels.items():  # every part printed before the first failure
        check(label + name, rel, tol)
    return worst


def phase_kernels(solver) -> tuple[list, dict]:
    """Each kernel against its plain version at the solver's size. Returns
    per kernel a record (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    library_ms) and the system timings.

    The finished Jacobian and its products are dominated by the unit
    diagonal of the Dirichlet rows (entries of 1 against element entries
    of about 1e-3 at box 55), so K2 and K3 are also compared unmasked
    (K2' mode: keep = 1, add = 0, no band), where the element scale sets
    the relative error."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.pc import NSFieldSplitPCT
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_plain
    from dedflow_tpu_torch.tools import selfcheck
    from dedflow_tpu_torch.tools.timing import nbytes, time_ms
    from dedflow_tpu_torch.utils import nvcc

    phys, scheme = solver.cfg.physics, solver.cfg.time
    lctx, fctxs, mask_t = solver.lctx, solver.face_ctxs, solver.mask_t
    wg, dwgold, dwg = perturbed_state(solver.mesh, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    # K1, K2 (masked) and K2' (unmasked): tools/selfcheck.py's pairs
    pairs = selfcheck.lattice_pairs(solver, wa, dwa)
    inp = pairs.inputs
    wa_t, dwa_t = inp["wa_t"], inp["dwa_t"]
    n, d0 = lctx.num_node, lctx.offsets.index(0)

    k1, p1 = pairs.k1.kernel, pairs.k1.plain
    err1 = compare("K1 F volume", k1, p1, pairs.k1.tol)
    same1 = torch.equal(k1(), lat._reduce_residual(lctx, ek.res_rows_call(
        lat._residual_inputs(lctx, wa_t, dwa_t), phys, scheme)))
    k1_regs = registers(nvcc.load("lattice_residual")["lattice_residual"],
                        "residual_fused_kernel", "KuhnCells")
    say(f"  K1 fused == K6's residual rows on the lattice inputs summed in the plain order "
        f"(the two-pass kernel's result), bit for bit: {same1}; ptxas registers {k1_regs}")
    if not same1:
        raise PhaseError("K1: the fused pass differs from the element rows summed in plain order")

    # K2 with the masked epilogue on the solver's own mask and facet band
    keep16, add16, band = inp["keep16"], inp["add16"], inp["band"]
    k2, p2 = pairs.k2.kernel, pairs.k2.plain
    err2 = compare("K2 data (masked)", k2, p2, pairs.k2.tol)
    err2u = compare("K2 data (unmasked)", pairs.k2u.kernel, pairs.k2u.plain, pairs.k2u.tol)
    err2 = max(err2, err2u)
    jm = lat.assemble_jacobian_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme)
    scal_p = torch.zeros_like(jm.scal)
    scal_p[2 * d0 : 2 * d0 + 2] = lctx.mult * inp["keep_pc"][16:18] + inp["add18"][16:18]
    err2 = max(err2, compare("K2 scal", lambda: jm.scal, lambda: scal_p, 0.0))

    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, n), generator=gen, device=solver.device, dtype=solver.dtype)
    k3 = lambda: dia_matvec(jm.data, jm.scal, x, lctx.offsets)
    p3 = lambda: dia_matvec_plain(jm.data, jm.scal, x, lctx.offsets)
    err3 = compare("K3 A x (masked)", k3, p3, TOL_K3)
    # unmasked data, zero phi/T rows: only element entries set the scale
    raw_data, no_scal = pairs.k2u.kernel(), torch.zeros_like(jm.scal)
    err3 = max(err3, compare(
        "K3 A x (unmasked)",
        lambda: dia_matvec(raw_data, no_scal, x, lctx.offsets),
        lambda: dia_matvec_plain(raw_data, no_scal, x, lctx.offsets), TOL_K3,
    ))
    del raw_data, no_scal
    out6 = torch.empty((6, n), dtype=torch.float32)
    r1 = finish(KERNELS[0][0], {"max_abs_err": err1}, k1, p1, 20, 5,
                nbytes(lctx.res_geom, wa_t, dwa_t, out6), op_count(p1))
    r2 = finish(KERNELS[1][0], {"max_abs_err": err2}, k2, p2, 10, 3,
                nbytes(lctx.lhs_geom, wa_t, keep16, add16, band, jm.data),
                op_count(p2))
    # K2', the unmasked mode (the same kernel and launch count as K2)
    finish("K2' lattice jacobian (unmasked)", {"max_abs_err": err2u},
           pairs.k2u.kernel, pairs.k2u.plain, 10, 3,
           nbytes(lctx.lhs_geom, wa_t, inp["ones16"], inp["zeros16"], jm.data),
           op_count(pairs.k2u.plain))
    # the library yardstick: torch.sparse CSR of the same assembled matrix
    offs = lctx.offsets
    pieces = []
    for k, o in enumerate(offs):
        r = torch.arange(max(0, -o), min(n, n - o), device=solver.device)
        by_comp = {c: jm.data[k, c, r] for c in range(16)}
        by_comp.update({16: jm.scal[2 * k, r], 17: jm.scal[2 * k + 1, r]})
        pieces.append((r, r + o, by_comp))
    csr = block_csr(n, pieces)
    xflat = x.reshape(-1)
    r3 = finish(KERNELS[2][0], {"max_abs_err": err3}, k3, p3, 100, 25,
                nbytes(jm.data, jm.scal, x, out6), op_count(p3),
                library=(lambda: csr @ xflat, k3()))
    del csr, pieces
    results = [r1, r2, r3]
    f_ms = time_ms(
        lambda: lat.assemble_residual_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme), 10
    )
    j_ms = time_ms(
        lambda: lat.assemble_jacobian_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme), 5
    )
    pc = NSFieldSplitPCT.from_diag_rows(jm.diag_rows())
    f = lat.assemble_residual_t(lctx, fctxs, mask_t, wa, dwa, phys, scheme)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()  # warm-up: the first call initialises cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_ms": j_ms, "SpMV_ms": results[2]["ms"],
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters}
    return results, times


def phase_slice() -> None:
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = box_mesh(*SLICE_BOX)
    cfg = reference_scenario_config()
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("slice", worst, TOL_SLICE)


def phase_main(solver) -> dict:
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    return drive_main(solver, (lat.residual_volume, lat.jacobian_volume, dia_matvec), "K1/K2/K3")


def phase_irregular_main(solver) -> dict:
    """drive_main on the WinELL tier: the staged K6 and K9's segment sum,
    never the column K6 or K9's staging pass. K10 gathers the input rows
    of every K6 launch, with the residual's row map before K6res and the
    Jacobian's before the staged K6: each instance has its own counter, and
    its launches must equal those of the K6 it feeds. Returns launches in
    IRREGULAR_KERNELS' order (the column Jacobian and K9 with its staging
    pass: 0), `staged`, those of the staged K6 and K9's segment sum, and
    `k10_launches`, those of K10's residual and Jacobian instances (the
    instance with the heat source is off this path)."""
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.sparse import win_gather as wg
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_staged
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce

    by_map = wg.win_gather.instances
    counters = (ek.res_rows_call, ek.lhs_rows_staged, winell_matvec, stream_reduce,
                ring_reduce_staged, wg.win_gather, by_map[wg.RESIDUAL_MAP],
                by_map[wg.JACOBIAN_MAP])
    out = drive_main(solver, counters, "K6res/K6staged/K7/K8/K9sum/K10/K10res/K10jac",
                     absent=(ek.lhs_rows_call, ring_reduce, by_map[wg.RESIDUAL_SOURCE_MAP]))
    n6r, n6j, n7, n8, n9, n10, n10r, n10j = out["launches"]
    if (n10r, n10j) != (n6r, n6j) or n10 != n10r + n10j:
        raise PhaseError(f"main: K10 launches {n10} (residual {n10r}, jacobian {n10j}), not "
                         f"one per K6 launch of its map ({n6r} + {n6j})")
    if n9 != n6j:
        raise PhaseError(f"main: {n9} K9 segment sums, not one per Jacobian ({n6j})")
    out["launches"] = [n6r, out["absent"][0], n7, n8, out["absent"][1]]
    out["staged"] = [n6j, n9]
    out["k10_launches"] = {"residual": n10r, "jacobian": n10j}
    return out


def irregular_solver():
    """NSSolver on the RCM-ordered Delaunay mesh, with the host set-up
    seconds of each part; also the mesh in its generated node order (the
    same triangulation), for the gather tier."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    t0 = time.perf_counter()
    raw = delaunay_mesh(DELAUNAY_POINTS, seed=SEED)
    t1 = time.perf_counter()
    mesh = reorder_mesh(raw, rcm_order(raw.ien, raw.num_node))
    t2 = time.perf_counter()
    cfg = reference_scenario_config(bcs=(), pin_pressure=True)
    solver = NSSolver(mesh, cfg, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    setup = {"delaunay_s": t1 - t0, "rcm_s": t2 - t1, "solver_s": t3 - t2}
    if solver.fastpath != "winell":
        raise PhaseError(f"irregular: fastpath {solver.fastpath!r}, expected 'winell'")
    return solver, setup, raw


def phase_irregular_kernels(solver) -> tuple[list, list, dict]:
    """K6 (residual, jacobian), K7, K8 and K9 against their plain versions
    at the solver's size, then the staged K6 (frozen, 33-row implicit) and
    K9's segment sum; per kernel a record as phase_kernels' (the column
    kernels', the staged ones') and the system timings. Rows whose scales
    differ by orders of magnitude are checked separately: the element
    Jacobian and its entry sums per velocity/pressure block (the phi/T
    identities are exact), the products and residuals per equation."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import element_rows as er
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.newton import assemble_system, residual
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain
    from dedflow_tpu_torch.sparse.winell import COMP2WIN
    from dedflow_tpu_torch.tools.timing import nbytes, time_ms
    from dedflow_tpu_torch.utils import nvcc

    phys, scheme = solver.cfg.physics, solver.cfg.time
    ctx, ne = solver.wctx, solver.wctx.num_elem
    wg, dwgold, dwg = perturbed_state(solver.mesh, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    inp67 = wa_.residual_inputs(ctx, wa, dwa)  # through K10
    # the Jacobian rows are a view of the context's buffer: kept by clones
    inp27 = wa_.jacobian_inputs(ctx, wa).clone()
    lhs_geom = torch.cat([ctx.jac_in[:12], ctx.jac_in[24:27]])  # element_rows.lhs_geom_rows
    same = (torch.equal(inp67, ek.res_gather_inputs(ctx.res_geom, ctx.ien_t, wa.T, dwa.T))
            and torch.equal(inp27, ek.lhs_gather_inputs(lhs_geom, ctx.ien_t, wa.T)))
    say(f"  element input rows through K10 equal the index gather's: {same}")
    if not same:
        raise PhaseError("K10: the WinELL element input rows differ from the index gather")
    rargs, largs = ek.res_args(phys, scheme), ek.lhs_args(phys, scheme)
    # the element Jacobian (rows ab*18+c) and its entry sums (WinELL rows)
    # per vel/p block, each against its own scale
    lhs_blocks = jacobian_blocks(ne, implicit=False)
    by_eq, entry_blocks = reduce_parts()

    k6r = lambda: ek.res_rows_call(inp67, phys, scheme)
    p6r = lambda: er.res_rows(inp67, **rargs)
    e6r = compare("K6 res rows", k6r, p6r, TOL_K6)
    k6j = lambda: ek.lhs_rows_call(inp27, phys, scheme)
    p6j = lambda: er.lhs_rows(inp27, **largs)
    e6j = compare("K6 lhs rows", k6j, p6j, TOL_K6, parts=lhs_blocks)
    # the 33-row implicit mode on the same elements (timed in phase 15)
    inp33 = wa_.jacobian_inputs(ctx, wa, scalar_implicit=True).clone()
    compare("K6 lhs rows, 33-row implicit", lambda: ek.lhs_rows_call(inp33, phys, scheme, True),
            lambda: er.lhs_rows(inp33, scalar_implicit=True, **largs), TOL_K6,
            parts=jacobian_blocks(ne, implicit=True))
    # the staged K6, the solver's Jacobian: frozen, then 33-row implicit
    plan, staged, outs = ctx.jac_plan, [], []
    for implicit, inp, tag in ((False, inp27, ""), (True, inp33, ", 33-row implicit")):
        rec, out = staged_record(
            f"K6 staged{tag}", plan,
            lambda inp=inp, i=implicit: ek.lhs_rows_staged(inp, phys, scheme, plan, i),
            lambda inp=inp, i=implicit: ek.lhs_rows_staged_plain(inp, phys, scheme, plan, i),
            lambda inp=inp, i=implicit: ek.stage_rows(plan, ek.lhs_rows_call(inp, phys, scheme, i), i),
            implicit, TOL_K6, nbytes(inp), 10)
        staged.append(rec)
        outs.append(out[0])
    stage16 = outs[0]  # the frozen mode's staging rows
    del inp33, out, outs
    out24, out288 = k6r(), k6j()

    k8 = lambda: stream_reduce(ctx.res_plan, out24, range(6), ne)
    p8 = lambda: stream_reduce_plain(ctx.res_plan, out24, range(6), ne)
    e8 = compare("K8 residual node reduce", k8, p8, TOL_K8, parts=by_eq)
    comps = wa_.JAC_COMPS
    k9 = lambda: ring_reduce(ctx.jac_plan, out288, comps, ne)
    p9 = lambda: ring_reduce_plain(ctx.jac_plan, out288, comps, ne)
    e9 = compare("K9 jacobian entry reduce", k9, p9, TOL_K9, parts=entry_blocks)
    staged.append(segment_sum_record(STAGED_KERNELS[2][0], plan, stage16, k9(), 20))
    del stage16

    jm, pc = assemble_system(ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, ctx.num_node), generator=gen, device=solver.device, dtype=solver.dtype)
    k7 = lambda: winell_matvec(jm, x)
    p7 = lambda: winell_matvec_plain(jm, x)
    e7 = compare("K7 A x", k7, p7, TOL_K7, parts=by_eq)

    names = [name for name, _, _ in IRREGULAR_KERNELS]
    plan = jm.plan
    csr = block_csr(ctx.num_node, [(
        plan.grow_t.long(), plan.col_t.long(),
        {c: jm.vals[int(COMP2WIN[c])] for c in range(18)},
    )])
    xflat = x.reshape(-1)
    out6 = torch.empty((6, ctx.num_node), dtype=torch.float32)
    results = [
        finish(names[0], {"max_abs_err": e6r}, k6r, p6r, 20, 3,
               nbytes(inp67, out24), op_count(p6r)),
        finish(names[1], {"max_abs_err": e6j}, k6j, p6j, 10, 3,
               nbytes(inp27, out288), op_count(p6j)),
        finish(names[2], {"max_abs_err": e7}, k7, p7, 100, 10,
               nbytes(jm.vals, plan.col_t, plan.row_ptr_t, x, out6), op_count(p7),
               library=(lambda: csr @ xflat, k7())),
        finish(names[3], {"max_abs_err": e8}, k8, p8, 50, 5,
               reduce_bytes(ctx.res_plan, range(6), 6), op_count(p8),
               library=(index_add_call(ctx.res_plan, out24, range(6), ne), k8())),
        finish(names[4], {"max_abs_err": e9}, k9, p9, 20, 3,
               reduce_bytes(ctx.jac_plan, comps, len(comps)), op_count(p9),
               library=(index_add_call(ctx.jac_plan, out288, comps, ne), k9())),
    ]
    del csr
    common = (ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    f_ms = time_ms(lambda: residual(*common, solver.cfg.freeze_phi_temperature), 10)
    j_ms = time_ms(lambda: assemble_system(*common), 5)
    f = residual(*common, solver.cfg.freeze_phi_temperature)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_ms": j_ms, "SpMV_ms": results[2]["ms"],
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters}
    libs = nvcc.load(["element_rows", "seg_reduce"])
    say(f"  ptxas registers: K6 staged frozen "
        f"{registers(libs['element_rows'], 'lhs_rows_staged_kernelILb0E')}, 33-row implicit "
        f"{registers(libs['element_rows'], 'lhs_rows_staged_kernelILb1E')} (column: "
        f"{registers(libs['element_rows'], 'lhs_rows_kernelILb0E')}, "
        f"{registers(libs['element_rows'], 'lhs_rows_kernelILb1E')}); K9 segment sum "
        f"{registers(libs['seg_reduce'], 'segment_sum_kernelILi16E')} (the tangents' 8-wide "
        f"{registers(libs['seg_reduce'], 'segment_sum_kernelILi8E')})")
    return results, staged, times


def phase_irregular_slice() -> None:
    """The converted box: card float32 (kernels) against CPU float64
    (plain versions), one step_fixed(num_newton=2), TOL_SLICE."""
    import dataclasses

    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = dataclasses.replace(box_mesh(*SLICE_BOX), lattice=None)
    mesh = reorder_mesh(mesh, rcm_order(mesh.ien, mesh.num_node))
    cfg = reference_scenario_config(use_lattice="winell")
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        if solver.fastpath != "winell" or not solver.face_ctxs:
            raise PhaseError("irregular slice: not on the winell tier with facets")
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"irregular slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("irregular slice", worst, TOL_SLICE)


def drive_main(solver, counters, label: str, absent=()) -> dict:
    """The main path: `solver.step` twice from the reference initial state
    with every launch counter set to 0 just before and read just after,
    then the first step repeated (bit-identical states and Krylov counts).
    Each of `counters` must have launched; none of `absent` (the entries
    the path no longer takes) may have."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy

    state0 = state_from_numpy(
        *reference_initial_state(solver.mesh), solver.device, solver.dtype
    )
    state, first = state0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters, *absent):
        c.launches = 0
    steps, newton, krylov = [], [], []
    for step in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        *state, stats = solver.step(*state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        first = first or (state, stats.krylov_iters)
        norms = [float(v) for v in stats.rnorms[-1]]
        steps.append(wall)
        newton.append(len(stats.rnorms))
        krylov.append(stats.krylov_iters)
        say(f"  step {step}: wall_s={wall:.4f} newton={len(stats.rnorms)} "
            f"krylov={stats.krylov_iters} converged={stats.converged} "
            f"field_norms={norms} launches {label} so far="
            f"{[c.launches for c in counters]}")
        if not all(map(math.isfinite, norms)):
            raise PhaseError(f"main: non-finite field norms at step {step}")
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise PhaseError(f"main: non-finite state at step {step}")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    off = {c.__name__: c.launches for c in absent}
    say(f"  launches {label} = {launches}; peak memory {peak / 2**30:.3f} GiB"
        + (f"; not on the path: {off}" if off else ""))
    if min(launches) <= 0:
        raise PhaseError(f"main: a kernel of the path was not launched: {launches}")
    if any(off.values()):
        raise PhaseError(f"main: an entry off the path was launched: {off}")
    *again, stats = solver.step(*state0)
    same = all(torch.equal(a, b) for a, b in zip(again, first[0]))
    say(f"  step 1 repeated: bit-identical states {same}, krylov {stats.krylov_iters}")
    if not same or stats.krylov_iters != first[1]:
        raise PhaseError("main: a repeated step differs from the first run")
    return {"launches": launches, "absent": list(off.values()), "step_s": steps,
            "newton": newton, "krylov": krylov, "peak_bytes": peak, "state": [t.cpu() for t in state],
            "first_state": [t.cpu() for t in first[0]]}


def dem_case(x):
    """(DEMConfig, GridState) of bench.py's DEM case for positions x in the
    unit box: radius DEM_RADIUS, cell 2.5 r, capacity from the occupancy
    (max + 1, at least 2), dt 1e-5, walls on the box (bench.py:515-532)."""
    import dataclasses

    import numpy as np

    from dedflow_tpu_torch.dem.cells import cell_stats, make_grid
    from dedflow_tpu_torch.dem.grid import to_grid
    from dedflow_tpu_torch.dem.integrate import DEMConfig
    from dedflow_tpu_torch.dem.particles import particle_state

    probe = make_grid([0, 0, 0], (1, 1, 1), cell_size=2.5 * DEM_RADIUS, capacity=2)
    k = max(2, cell_stats(probe, x)["max_per_cell"] + 1)
    grid = dataclasses.replace(probe, capacity=k)
    cfg = DEMConfig(grid=grid, dt=1e-5, walls_lo=(0, 0, 0), walls_hi=(1, 1, 1))
    st = particle_state(np.asarray(x, dtype=np.float64), radius=DEM_RADIUS, mass=1.0,
                        device="cuda")
    return cfg, to_grid(grid, st, x.shape[0])


def live_pairs(grid, gs) -> tuple[int, int]:
    """(live slots, live pair slots): the (centre, neighbour) slot pairs of
    the 27-offset sweep with both slots occupied, itself included, at the
    flat neighbour index the sweep reads (in range, row wraps as they are)."""
    import torch

    from dedflow_tpu_torch.dem.grid import _offsets

    occ = gs.mask.sum(0).double()  # particles per cell
    nc = occ.numel()
    pairs = 0.0
    for o in _offsets(grid):
        lo, hi = max(0, -o), min(nc, nc - o)
        pairs += float((occ[lo:hi] * occ[lo + o : hi + o]).sum())
    return int(occ.sum()), int(pairs)


def k11_record(label: str, grid, gs, prm) -> dict:
    """K11 against its plain twin on one grid state: checked, timed, with
    its bound from this state's occupancy (the sweep skips empty slots and
    pairs, so the work it needs is the live pairs', and the bytes are the
    mask and outputs of every slot plus the other eight fields of the live
    slots); the dense bound (every slot and pair) is printed beside it."""
    import torch

    from dedflow_tpu_torch.dem.grid import grid_pair_forces, grid_pair_forces_cuda
    from dedflow_tpu_torch.tools.timing import bound

    kernel = lambda: torch.stack(grid_pair_forces_cuda(grid, gs, prm))
    plain = lambda: torch.stack(grid_pair_forces(grid, gs, prm))
    err = compare(label, kernel, plain, TOL_K11)
    k, nc = gs.mask.shape
    slots = k * nc
    live, pairs = live_pairs(grid, gs)
    dense_pairs = 27 * k * k * nc
    dense_ops, skipped = op_count(plain)
    live_ops = dense_ops * pairs / dense_pairs
    live_bytes = 4 * slots + 32 * live + 12 * slots
    dense_ms, dense_by = bound(48 * slots, dense_ops)
    rec = finish(label, {"max_abs_err": err}, kernel, plain, 20, 3, live_bytes,
                 (live_ops, skipped))
    say(f"  {label}: K={k} NC={nc} live slots {live} live pair slots {pairs} of "
        f"{dense_pairs} ({dense_ops / dense_pairs:.1f} op each); dense bound "
        f"{dense_ms:.4f} ms ({dense_by}: {48 * slots / 1e6:.1f} MB, {dense_ops / 1e9:.2f} Gop); "
        f"pair slots/s {dense_pairs / (rec['ms'] * 1e-3):.3e}, live pairs/s "
        f"{pairs / (rec['ms'] * 1e-3):.3e}")
    return rec


def phase_dem(coupled_gs) -> dict:
    """Phase 9: K11 at bench.py's DEM cases (with grid_run ms per substep)
    and at the coupled scenario's grid, whose record is returned."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.dem.grid import grid_run

    rng = np.random.RandomState(0)  # bench.py:576-592, the same draws
    p0 = 100_000
    x_uni = rng.uniform(0.02, 0.98, size=(p0, 3)).astype(np.float32)
    s = DEM_RADIUS * (4.0 * np.pi / (3.0 * 0.45)) ** (1.0 / 3.0)
    npx = int(1.0 / s)
    ii = np.arange(p0)
    gx = (ii % npx + 0.5) * s
    gy = ((ii // npx) % npx + 0.5) * s
    gz = (ii // (npx * npx) + 0.5) * s
    jit = (rng.uniform(-0.08, 0.08, size=(p0, 3)) * s).astype(np.float32)
    x_bed = np.stack([gx, gy, gz], axis=1).astype(np.float32) + jit
    for name, x in (("uniform_100k", x_uni), ("settled_bed_100k", x_bed)):
        cfg, gs = dem_case(x)
        dropped = p0 - int(gs.mask.sum())
        say(f"  {name}: grid {cfg.grid.dims}, dropped {dropped}")
        k11_record(f"K11 {name}", cfg.grid, gs, cfg.contact)
        run = lambda: grid_run(cfg, gs, 1.0, DEM_SUBSTEPS)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        say(f"  {name}: grid_run {(time.perf_counter() - t0) / DEM_SUBSTEPS * 1e3:.3f} "
            f"ms per substep over {DEM_SUBSTEPS} substeps")
    grid, gs, prm = coupled_gs
    say(f"  coupled grid: {grid.dims}, K={grid.capacity}")
    return k11_record(DEM_KERNELS[0][0], grid, gs, prm)


def pair_gaps(x, r):
    """Surface gaps |x_i - x_j| - (r_i + r_j) of every pair (float64)."""
    import numpy as np

    d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    g = d - (r[:, None] + r[None, :])
    return g[np.triu_indices(len(x), 1)]


def phase_coupled_slice() -> None:
    """Phase 10: CoupledSolver on box 12, one step(num_newton=2), card f32
    (K1-K3, K11) against CPU f64 (plain versions). The cloud (SLICE_PARTICLES
    of radius SLICE_RADIUS) is the seed among 0..15 whose closest pair to
    contact (|gap|) is farthest from it; after the step the run checks
    that no pair's gap changed sign and that the gap margin exceeds four
    times the largest displacement, so no contact switched on or off in
    either precision."""
    import dataclasses

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.coupled import CoupledSolver
    from dedflow_tpu_torch.app.scenarios import coupled_scenario_setup, reference_scenario_config
    from dedflow_tpu_torch.dem.cells import cell_stats
    from dedflow_tpu_torch.mesh.gen import box_mesh

    mesh = box_mesh(*SLICE_BOX)
    setup = lambda seed, dev: coupled_scenario_setup(
        mesh, num_particles=SLICE_PARTICLES, radius=SLICE_RADIUS, seed=seed, device=dev
    )
    margin = lambda seed: float(np.abs(pair_gaps(
        setup(seed, "cpu")[1].x.numpy(), np.full(SLICE_PARTICLES, SLICE_RADIUS)
    )).min())
    seed = max(range(16), key=margin)
    ccfg, pst = setup(seed, "cpu")
    x0 = pst.x.numpy()
    # capacity from the occupancy (the scenario's 8 would only pad the sweep)
    k = cell_stats(ccfg.dem.grid, x0)["max_per_cell"] + 1
    ccfg = dataclasses.replace(ccfg, dem=dataclasses.replace(
        ccfg.dem, grid=dataclasses.replace(ccfg.dem.grid, capacity=k)))
    outs = []
    for device in ("cuda", "cpu"):
        pst = setup(seed, device)[1]
        solver = CoupledSolver(mesh, reference_scenario_config(), ccfg, device=device)
        state = perturbed_state(mesh, device, solver.dtype)
        *fluid, pst1, _ = solver.step(*state, pst, num_newton=2)
        outs.append(([t.cpu() for t in fluid], pst1.x.cpu(), pst1.v.cpu()))
    (gfl, gx, gv), (rfl, rx, rv) = outs
    r = np.full(SLICE_PARTICLES, SLICE_RADIUS)
    g0, g1 = pair_gaps(x0, r), pair_gaps(rx.numpy(), r)
    moved = float(np.abs(rx.numpy() - x0).max())
    m0 = float(np.abs(g0).min())
    say(f"  seed {seed}, K={k}: {int((g0 < 0).sum())} touching pairs, min |gap| {m0:.3e}, "
        f"largest displacement {moved:.3e}")
    if np.any((g0 < 0) != (g1 < 0)) or m0 <= 4 * moved:
        raise PhaseError("coupled slice: a contact may switch within the step")
    worst = 0.0
    for name, g, ref in zip(("wgold", "dwgold", "dwg"), gfl, rfl):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"coupled slice: non-finite {name} on the card")
        _, rel = rel_err(g, ref)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("coupled slice fluid", worst, TOL_SLICE)
    for name, g, ref in (("x", gx, rx), ("v", gv, rv)):
        _, rel = rel_err(g, ref)
        say(f"  particles {name}: card f32 vs cpu f64 rel={rel:.3e} (tol {TOL_PARTICLES:.0e})")
        check(f"coupled slice particles {name}", rel, TOL_PARTICLES)


def phase_coupled_main(solver, pstate0) -> dict:
    """Phase 11: the coupled main path, CoupledSolver.step twice (adaptive)
    from the reference initial state, every launch counter set to 0 just
    before and read just after; then step 1 repeated (bit-identical fluid
    and particle states, equal Krylov counts)."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.dem.grid import grid_pair_forces_cuda
    from dedflow_tpu_torch.dem.integrate import kinetic_energy
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    counters = (lat.residual_volume, lat.jacobian_volume, dia_matvec, grid_pair_forces_cuda)
    state0 = state_from_numpy(*reference_initial_state(solver.fluid.mesh), "cuda", solver.dtype)
    state, pst, first = state0, pstate0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    walls = []
    for step in (1, 2):
        parts = {}
        t0 = time.perf_counter()
        *state, pst, stats = solver.step(*state, pst, timings=parts)
        wall = time.perf_counter() - t0
        first = first or (state, pst, stats.krylov_iters, len(stats.rnorms))
        norms = [float(v) for v in stats.rnorms[-1]]
        ke = float(kinetic_energy(pst))
        walls.append(wall)
        say(f"  step {step}: wall_s={wall:.4f} drag_s={parts['drag_s']:.4f} "
            f"fluid_s={parts['fluid_s']:.4f} dem_s={parts['dem_s']:.4f} "
            f"newton={len(stats.rnorms)} krylov={stats.krylov_iters} "
            f"converged={stats.converged} field_norms={norms} particle_ke={ke:.6e}")
        if not all(map(math.isfinite, norms + [ke])):
            raise PhaseError(f"coupled main: non-finite norms or energy at step {step}")
        if not all(bool(torch.isfinite(t).all()) for t in (*state, pst.x, pst.v)):
            raise PhaseError(f"coupled main: non-finite state at step {step}")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    say(f"  launches K1/K2/K3/K11 = {launches}; peak memory {peak / 2**30:.3f} GiB")
    if min(launches) <= 0:
        raise PhaseError(f"coupled main: a kernel of the path was not launched: {launches}")
    *again, pst_again, stats = solver.step(*state0, pstate0)
    same = all(torch.equal(a, b) for a, b in zip(again, first[0]))
    same_p = torch.equal(pst_again.x, first[1].x) and torch.equal(pst_again.v, first[1].v)
    say(f"  step 1 repeated: bit-identical fluid {same}, particles {same_p}, "
        f"krylov {stats.krylov_iters}")
    if not (same and same_p) or stats.krylov_iters != first[2]:
        raise PhaseError("coupled main: a repeated step differs from the first run")
    # phase 27's reference: the first step's states and particles, on the host
    host = {"state": [t.cpu() for t in first[0]], "x": first[1].x.cpu(), "v": first[1].v.cpu(),
            "newton": first[3]}
    return {"launches": launches, "step_s": walls, "peak_bytes": peak, "first": host,
            "x0": pstate0.x.cpu()}


def ptxas_of(lib, *parts) -> dict:
    """What ptxas printed for the entry whose mangled name contains every
    one of `parts`: registers, spill stores and loads (bytes); {} if none."""
    entry, out = None, {}
    for ln in lib.ptxas:
        if "Function properties for" in ln:
            entry = ln if all(p in ln for p in parts) else None
            if entry is None and out:
                break
        elif entry is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out["spill_stores"] = int(words[words.index("spill") - 2])
            out["spill_loads"] = int(words[len(words) - 1 - words[::-1].index("spill") - 2])
        elif entry is not None and "registers" in ln:
            out["registers"] = int(ln.split("Used ")[1].split(" registers")[0])
    return out


def registers(lib, *parts) -> int | None:
    """The register count ptxas printed for the entry whose mangled name
    contains every one of `parts`."""
    return ptxas_of(lib, *parts).get("registers")


def busy_share(fn) -> str:
    """The device's busy share over one call of `fn` (torch.profiler: the
    union of the device events' intervals over the host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise PhaseError("busy share: the profiler recorded no device events")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return (f"{busy / 1e3:.2f} ms of device time in {wall * 1e3:.2f} ms of wall "
            f"(busy {busy / 1e6 / wall:.1%}, {len(spans)} device events)")


def gather_solver(raw):
    """NSSolver on the Delaunay mesh in its generated node order: the
    "auto" ladder falls to the general gather tier."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.solver.newton import NSSolver

    t0 = time.perf_counter()
    solver = NSSolver(raw, reference_scenario_config(**GATHER_CONFIG), device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if solver.fastpath != "gather":
        raise PhaseError(f"gather: fastpath {solver.fastpath!r}, expected 'gather'")
    return solver, setup_s


def state_sector_bytes(ien_t, comps: int, cols: int = 6) -> int:
    """Bytes of the 32-byte sectors of a node-major (N, cols) float32 array
    whose first `comps` columns K10 reads at the nodes of `ien_t`."""
    import torch

    from dedflow_tpu_torch.tools.timing import sector_bytes

    nodes = torch.unique(ien_t.long())
    return sector_bytes((cols * nodes[:, None] + torch.arange(comps, device=nodes.device))
                        .reshape(-1))


def k10_checks(mesh, ien_t, res_geom, scheme) -> dict:
    """K10 against its plain version (bit for bit), node-major states in,
    rows out into K6's input layout, on (4, ne) connectivity `ien_t` of
    `mesh` at its perturbed state: the residual map with the geometry
    rows `res_geom` copied in (the (67, ne) rows the solver's residual
    reads), the same with a heat source, the residual map alone (rows
    19-66 of a given buffer: the function the former kernel computed
    from a (14, N) table) and the Jacobian map (rows 12-23). {tag: (max abs error,
    kernel, plain, bytes, library)}: the timed calls write into one
    buffer each. The library calls: for the Jacobian map one indexing of
    w_alpha; for the residual map one indexing T[eidx, cidx] of the
    node-major (N, 14) table of the JAX row map's columns (w_alpha, the
    source or zeros, dw_alpha; built outside the timing, as are the
    indices), and where the geometry is copied in, that indexing and the
    cat of the geometry rows with it (the former residual_inputs)."""
    import torch

    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.sparse import win_gather as wg
    from dedflow_tpu_torch.tools.timing import nbytes

    ne = ien_t.shape[1]
    w, dw = alpha_states(*perturbed_state(mesh, "cuda", torch.float32), scheme)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    src = torch.rand(mesh.num_node, generator=gen, device="cuda")
    # each state array's sectors at the mesh's nodes: all 6 comps, the velocities, the source
    sectors = {"all": state_sector_bytes(ien_t, 6), "u": state_sector_bytes(ien_t, 3),
               "source": state_sector_bytes(ien_t, 1, 1)}
    cases = {
        "residual": (67, 19, (w, dw, None), res_geom),
        "residual, heat source": (67, 19, (w, dw, src), res_geom),
        "residual map alone": (48 + 19, 19, (w, dw, None), None),
        "jacobian": (24, 12, (w,), None),
    }
    # the residual map's (a, c) a row, and the (N, 14) tables it indexes
    pairs = sorted((r, a, c) for a, row in enumerate(wg.RES_ROWMAP) for c, r in enumerate(row)
                   if r >= 0)
    rmap_a = torch.tensor([a for _, a, _ in pairs], device="cuda")
    rmap_c = torch.tensor([c for _, _, c in pairs], device="cuda")[:, None]
    res_eidx = ien_t.long()[rmap_a]
    tables = {}
    for with_src in (False, True):
        t = torch.zeros((mesh.num_node, 14), dtype=torch.float32, device="cuda")
        t[:, :6], t[:, 8:] = w, dw
        if with_src:
            t[:, 6] = src
        tables[with_src] = t
    k10 = {}
    for tag, (rows, row0, states, geom) in cases.items():
        nrows = 48 if len(states) == 3 else 12
        bufs = [torch.empty((rows, ne), dtype=torch.float32, device="cuda") for _ in range(2)]
        kern = lambda b=bufs[0], r=row0, st=states, g=geom: wg.win_gather(ien_t, b, r, *st, geom=g)
        plain = (lambda b=bufs[1], r=row0, st=states, g=geom:
                 wg.win_gather_plain(ien_t, b, r, *st, geom=g))
        lo = 0 if geom is not None else row0  # the rows the call writes
        err = compare(f"K10 win gather ({tag})", lambda k=kern, lo=lo, hi=row0 + nrows:
                      k()[lo:hi].clone(), lambda p=plain, lo=lo, hi=row0 + nrows: p()[lo:hi],
                      0.0)
        if nrows == 12:
            reads = sectors["u"]
        else:
            reads = 2 * sectors["all"] + (sectors["source"] if states[2] is not None else 0)
        bytes_ = nbytes(ien_t, geom) + 4 * (row0 + nrows - lo) * ne + reads
        if tag == "jacobian":
            a = torch.tensor([r % 4 for r in range(12)], device="cuda")
            cidx = torch.tensor([r // 4 for r in range(12)], device="cuda")[:, None]
            eidx = ien_t.long()[a]
            library = (lambda e=eidx, c=cidx: w[e, c], kern()[12:24].clone())
        else:
            table = tables[states[2] is not None]
            index = lambda t=table: t[res_eidx, rmap_c]
            call = index if geom is None else lambda i=index, g=geom: torch.cat([g, i()])
            library = (call, kern()[lo:row0 + nrows].clone())
        k10[tag] = (err, kern, plain, bytes_, library)
    say("  K10's state sectors (MB): "
        + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in sectors.items()))
    return k10


def k10_order_ms(mesh, ien_t, res_geom) -> dict:
    """K10's residual instance (the 19 geometry rows copied in) timed on
    `ien_t` as the solver holds it and with its element columns (and the
    geometry's) in three other orders: sorted by minimum node (the RCM
    Delaunay mesh's convention, mesh.reorder), the Morton order of the
    element centroids (a warp's 32 elements in one small cube of space),
    and shuffled. The bound does not move: every node's states are read
    and every row written in each order. {order: ms}."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.sparse import win_gather as wg
    from dedflow_tpu_torch.tools.timing import time_ms

    ne = ien_t.shape[1]
    ien = ien_t.T.cpu().numpy()
    cent = mesh.xg[ien].mean(axis=1)
    q = ((cent - cent.min(0)) / np.maximum(np.ptp(cent, axis=0), 1e-300) * 1023).astype(np.int64)
    code = np.zeros(ne, dtype=np.int64)
    for bit in range(10):
        for d in range(3):
            code |= ((q[:, d] >> bit) & 1) << (3 * bit + d)
    orders = {"as held": None, "min node": np.argsort(ien.min(axis=1), kind="stable"),
              "morton": np.argsort(code, kind="stable"),
              "shuffled": np.random.default_rng(SEED).permutation(ne)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    w, dw = torch.randn((2, mesh.num_node, 6), generator=gen, device="cuda")
    buf = torch.empty((67, ne), dtype=torch.float32, device="cuda")
    out = {}
    for tag, perm in orders.items():
        it, g = ien_t, res_geom
        if perm is not None:
            p = torch.as_tensor(perm, device="cuda")
            it, g = ien_t[:, p].contiguous(), res_geom[:, p].contiguous()
        out[tag] = time_ms(lambda it=it, g=g: wg.win_gather(it, buf, 19, w, dw, geom=g), 50)
    say("  K10 residual (geometry copied in) by element order, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def k10_records(k10: dict, names, tags=("residual", "jacobian")) -> list:
    """The records of k10_checks' gathers `tags` under `names`, as
    finish() makes them."""
    out = []
    for name, tag in zip(names, tags):
        err, kern, plain, bytes_, library = k10[tag]
        out.append(finish(name, {"max_abs_err": err}, kern, plain, 50, 5, bytes_, (0, []),
                          library=library))
    return out


def phase_gather_kernels(gsolver, rcm, rcm_ien_t, rcm_geom) -> tuple[list, list, list, dict,
                                                                   dict, list, dict]:
    """Phase 12: K4 and K5 on the gather tier's context (K5 also in its
    implicit mode, the metric rows read in place from the residual
    geometry), K10 on phase 6's RCM mesh `rcm`, its WinELL connectivity
    `rcm_ien_t` and residual geometry `rcm_geom` (on the host), K8 and K9
    on the gather tier's plans, each against its plain version; then the
    staged K5 (frozen, implicit) and K9's segment sum on the gather plan,
    and the staged K4 and K8's segment sum on the residual plan. Returns the six kernel records (GATHER_KERNELS' order),
    the three staged Jacobian records, the two staged residual records
    (RESIDUAL_STAGED_KERNELS' order), the gather tier's system timings,
    K5's implicit record, K10's records in K10_KERNELS' order and K7's
    record on the gather tier's matrix (generated node order)."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.newton import assemble_system, residual
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain
    from dedflow_tpu_torch.sparse.winell import COMP2WIN
    from dedflow_tpu_torch.tools.timing import nbytes, time_ms
    from dedflow_tpu_torch.utils import nvcc

    phys, scheme = gsolver.cfg.physics, gsolver.cfg.time
    ctx, ne = gsolver.gctx, gsolver.gctx.num_elem
    wg_, dwgold, dwg = perturbed_state(gsolver.mesh, gsolver.device, gsolver.dtype)
    wa, dwa = alpha_states(wg_, dwgold, dwg, scheme)
    w_t, dw_t = wa.T.contiguous(), dwa.T.contiguous()
    lhs_blocks = jacobian_blocks(ne, implicit=False)

    k4 = lambda: ek.ns_residual_gather(ctx.res_geom, ctx.ien_t, w_t, dw_t, phys, scheme)
    p4 = lambda: ek.ns_residual_gather_plain(ctx.res_geom, ctx.ien_t, w_t, dw_t, phys, scheme)
    e4 = compare("K4 gathered residual", k4, p4, TOL_K4)
    k5 = lambda: ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme)
    p5 = lambda: ek.ns_lhs_gather_plain(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme)
    e5 = compare("K5 gathered jacobian", k5, p5, TOL_K5, parts=lhs_blocks)
    met = ctx.res_geom[13:19]  # the metric rows, a strided view
    k5i = lambda: ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme, met)
    p5i = lambda: ek.ns_lhs_gather_plain(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme, met)
    e5i = compare("K5 gathered jacobian, implicit", k5i, p5i, TOL_K5,
                  parts=jacobian_blocks(ne, implicit=True))
    # K4/K5 equal K6 on the same inputs: one element body (element_body.cuh)
    same4 = torch.equal(k4(), ek.res_rows_call(ek.res_gather_inputs(
        ctx.res_geom, ctx.ien_t, w_t, dw_t), phys, scheme))
    same5 = torch.equal(k5(), ek.lhs_rows_call(ek.lhs_gather_inputs(
        ctx.lhs_geom, ctx.ien_t, w_t), phys, scheme))
    same5i = torch.equal(k5i(), ek.lhs_rows_call(ek.lhs_gather_inputs(
        ctx.lhs_geom, ctx.ien_t, w_t, met), phys, scheme, scalar_implicit=True))
    say(f"  K4 == K6 residual rows on the same inputs: {same4}; K5 == K6 jacobian rows: {same5}; "
        f"implicit: {same5i}")
    if not (same4 and same5 and same5i):
        raise PhaseError("K4/K5: not equal to K6 on the same inputs (one element body)")

    # K10 on the RCM mesh, with the WinELL tier's two row maps
    k10 = k10_checks(rcm, rcm_ien_t, rcm_geom.to("cuda"), scheme)

    # K8 and K9 on the gather tier's plans: the element rows of an
    # unordered mesh, read where K4/K5 left them
    (rng,) = ctx.ranges
    rows24, rows288 = k4(), k5()
    by_eq, entry_blocks = reduce_parts()
    comps = wa_.JAC_COMPS
    k8 = lambda: stream_reduce(rng.res_plan, rows24, range(6), ne)
    p8 = lambda: stream_reduce_plain(rng.res_plan, rows24, range(6), ne)
    e8 = compare("K8 residual node reduce (gather plan)", k8, p8, TOL_K8, parts=by_eq)
    k9 = lambda: ring_reduce(rng.jac_plan, rows288, comps, ne)
    p9 = lambda: ring_reduce_plain(rng.jac_plan, rows288, comps, ne)
    e9 = compare("K9 jacobian entry reduce (gather plan)", k9, p9, TOL_K9, parts=entry_blocks)
    # the staged K5, the solver's Jacobian, and K9's segment sum on its rows
    plan, staged, stage16 = rng.jac_plan, [], None
    for implicit, metric, tag in ((False, None, ""), (True, met, ", implicit")):
        rec, out = staged_record(
            f"K5 staged{tag}", plan,
            lambda m_=metric: ek.ns_lhs_gather_staged(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme,
                                                      plan, m_),
            lambda m_=metric: ek.ns_lhs_gather_staged_plain(ctx.lhs_geom, ctx.ien_t, w_t, phys,
                                                            scheme, plan, m_),
            lambda m_=metric, i=implicit: ek.stage_rows(
                plan, ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme, m_), i),
            implicit, TOL_K5, nbytes(ctx.lhs_geom, ctx.ien_t, w_t[:3], metric), 10)
        staged.append(rec)
        stage16 = out[0] if stage16 is None else stage16
        del out
    staged.append(segment_sum_record(STAGED_KERNELS[5][0], plan, stage16, k9(), 20))
    del stage16
    # the staged K4, the solver's residual (node-major states), and K8's
    # segment sum on its rows
    w, dw = wa.contiguous(), dwa.contiguous()
    rplan = rng.res_plan
    k4s = lambda: ek.ns_residual_gather_staged(ctx.res_geom, ctx.ien_t, w, dw, phys, scheme, rplan)
    p4s = lambda: ek.ns_residual_gather_staged_plain(ctx.res_geom, ctx.ien_t, w, dw, phys, scheme,
                                                     rplan)
    label = RESIDUAL_STAGED_KERNELS[0][0]
    e4s = compare(label, k4s, p4s, TOL_K4, parts={" [rows]": lambda t: t[:, :6],
                                                  " [padding]": lambda t: t[:, 6:]})
    stage8 = k4s()
    same = torch.equal(stage8, ek.stage_residual_rows(rplan, rows24))
    say(f"  {label} == the column K4's rows at the plan positions, bit for bit: {same}")
    if not same:
        raise PhaseError(f"{label}: the staged rows differ from the column kernel's")
    k = rplan.src.numel()
    # the function's output: 6 floats a contribution; the (K, 8) rows' 2 zeros
    # are the layout's cost
    res_staged = [finish(label, {"max_abs_err": e4s}, k4s, p4s, 20, 3,
                         nbytes(ctx.res_geom, ctx.ien_t, w, dw, rplan.elem_pos) + 4 * 6 * k,
                         op_count(p4s))]
    res_staged.append(segment_sum_record(RESIDUAL_STAGED_KERNELS[1][0], rplan, stage8, k8(), 50,
                                         residual=True))
    del stage8

    names = [name for name, _, _ in GATHER_KERNELS]
    libs = nvcc.load(["gather_elements", "win_gather"])
    regs = {names[0]: registers(libs["gather_elements"], "res_gather_kernel"),
            names[1]: registers(libs["gather_elements"], "lhs_gather_kernelILb0E"),
            names[2]: registers(libs["win_gather"], "win_gather_kernelILi1E"),
            names[3]: registers(libs["win_gather"], "win_gather_kernelILi0E"),
            K10_KERNELS[0][0]: registers(libs["win_gather"], "win_gather_kernelILi2E")}
    out24 = torch.empty((24, ne), dtype=torch.float32)
    out288 = torch.empty((288, ne), dtype=torch.float32)
    results = [
        finish(names[0], {"max_abs_err": e4}, k4, p4, 20, 3,
               nbytes(ctx.res_geom, ctx.ien_t, w_t, dw_t, out24), op_count(p4)),
        finish(names[1], {"max_abs_err": e5}, k5, p5, 10, 3,
               nbytes(ctx.lhs_geom, ctx.ien_t, w_t[:3], out288), op_count(p5)),
    ]
    results += k10_records(k10, names[2:4])
    results += [
        finish(names[4], {"max_abs_err": e8}, k8, p8, 50, 5,
               reduce_bytes(rng.res_plan, range(6), 6), op_count(p8),
               library=(index_add_call(rng.res_plan, rows24, range(6), ne), k8())),
        finish(names[5], {"max_abs_err": e9}, k9, p9, 20, 3,
               reduce_bytes(rng.jac_plan, comps, len(comps)), op_count(p9),
               library=(index_add_call(rng.jac_plan, rows288, comps, ne), k9())),
    ]
    implicit5 = finish(MELT_KERNELS[3][0], {"max_abs_err": e5i}, k5i, p5i, 10, 3,
                       nbytes(ctx.lhs_geom, met, ctx.ien_t, w_t[:3], out288), op_count(p5i))
    regs[MELT_KERNELS[3][0]] = registers(libs["gather_elements"], "lhs_gather_kernelILb1E")
    regs[STAGED_KERNELS[3][0]] = registers(libs["gather_elements"], "lhs_gather_staged_kernelILb0E")
    regs[STAGED_KERNELS[4][0]] = registers(libs["gather_elements"], "lhs_gather_staged_kernelILb1E")
    regs[RESIDUAL_STAGED_KERNELS[0][0]] = registers(libs["gather_elements"],
                                                    "res_gather_staged_kernelILb1E")
    for name in regs:
        say(f"  {name}: ptxas registers {regs[name]}")

    # the gather tier's system: F, J (+ PC), the SpMV on its matrix, GMRES(120)
    common = (ctx, gsolver.face_ctxs, gsolver.mask_t, wg_, dwgold, dwg, phys, scheme)
    f_ms = time_ms(lambda: residual(*common, gsolver.cfg.freeze_phi_temperature), 10)
    j_ms = time_ms(lambda: assemble_system(*common), 5)
    jm, pc = assemble_system(*common)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((6, ctx.num_node), generator=gen, device="cuda", dtype=gsolver.dtype)
    k7 = lambda: winell_matvec(jm, x)
    p7 = lambda: winell_matvec_plain(jm, x)
    e7 = compare("K7 A x (gather matrix, generated order)", k7, p7, TOL_K7, parts=reduce_parts()[0])
    plan = jm.plan
    csr = block_csr(ctx.num_node, [(plan.grow_t.long(), plan.col_t.long(),
                                    {c: jm.vals[int(COMP2WIN[c])] for c in range(18)})])
    xflat = x.reshape(-1)
    k7_rec = finish(GATHER_SPMV_KERNELS[0][0], {"max_abs_err": e7}, k7, p7, 100, 10,
                    nbytes(jm.vals, plan.col_t, plan.row_ptr_t, x, x), op_count(p7),
                    library=(lambda: csr @ xflat, k7()))
    del csr
    spmv_ms = k7_rec["ms"]
    f = residual(*common, gsolver.cfg.freeze_phi_temperature)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_ms": j_ms, "SpMV_ms": spmv_ms,
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters,
             "matrix_entries": ctx.win_plan.S}
    k10_extra = k10_records(k10, [n for n, _, _ in K10_KERNELS],
                            ("residual, heat source", "residual map alone"))
    return results, staged, res_staged, times, implicit5, k10_extra, k7_rec


def phase_gather_slice() -> None:
    """Phase 13: box 12 on the gather tier, reference BCs with the Nitsche
    wall: card float32 (K4/K5/K7-K9) against CPU float64 (plain versions),
    one step_fixed(num_newton=2), TOL_SLICE."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    mesh = box_mesh(*SLICE_BOX)
    cfg = reference_scenario_config(use_lattice="gather")
    outs = []
    for device in ("cuda", "cpu"):
        solver = NSSolver(mesh, cfg, device=device)
        if solver.fastpath != "gather" or not solver.face_ctxs:
            raise PhaseError("gather slice: not on the gather tier with facets")
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"gather slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("gather slice", worst, TOL_SLICE)


def phase_gather_main(gsolver) -> dict:
    """Phase 14: the gather tier's main path (drive_main: the staged K4 and
    K8's segment sum, the staged K5 and K9's segment sum, never the column
    K4 / K5 or K8's / K9's staging pass), then the busy share of the device
    over one Newton iteration. Returns launches in the order K4, K5, K7,
    K8, K9 (the column K4 / K5 and K8 / K9 with their staging pass: 0),
    `staged`, those of the staged K5 and K9's segment sum, and
    `res_staged`, those of the staged K4 and K8's segment sum."""
    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import newton_iter, predict, residual
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_staged
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_staged

    counters = (ek.ns_residual_gather_staged, ek.ns_lhs_gather_staged, winell_matvec,
                stream_reduce_staged, ring_reduce_staged)
    out = drive_main(gsolver, counters, "K4staged/K5staged/K7/K8sum/K9sum",
                     absent=(ek.ns_residual_gather, ek.ns_lhs_gather, stream_reduce, ring_reduce))
    n4, n5, n7, n8, n9 = out["launches"]
    if n9 != n5:
        raise PhaseError(f"main: {n9} K9 segment sums, not one per Jacobian ({n5})")
    if n8 != n4:
        raise PhaseError(f"main: {n8} K8 segment sums, not one per residual ({n4})")
    out["launches"] = [out["absent"][0], out["absent"][1], n7, out["absent"][2], out["absent"][3]]
    out["staged"] = [n5, n9]
    out["res_staged"] = [n4, n8]
    cfg = gsolver.cfg
    wg, dwgold, dwg = state_from_numpy(*reference_initial_state(gsolver.mesh), "cuda", gsolver.dtype)
    dwg = predict(dwg, cfg.time)
    ctx = (gsolver.gctx, gsolver.face_ctxs, gsolver.mask_t)
    f = residual(*ctx, wg, dwgold, dwg, cfg.physics, cfg.time, cfg.freeze_phi_temperature)
    it = lambda: newton_iter(*ctx, wg, dwgold, dwg, f, cfg.physics, cfg.time, cfg.krylov,
                             cfg.freeze_phi_temperature)
    it()  # warm
    say(f"  one Newton iteration under torch.profiler: {busy_share(it)}")
    return out


def rcb_probe_vector(num_node: int, device, dtype):
    """(6, N) seeded vector for phase 26 (b)'s product and field-split apply."""
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal((6, num_node)),
                           dtype=dtype, device=device)


def rcb_operator(solver, state, x) -> dict:
    """F, J x and the field-split apply P x at `state` on `solver`'s own rows
    (all rows in one process; a rank's own rows in the RCB mode, J x through
    the halo exchange and K7's halo entry), each (rows, 6)."""
    from dedflow_tpu_torch.solver.newton import assemble_system, residual

    cfg, ctx = solver.cfg, (solver.solve_ctx, solver.face_ctxs, solver.mask_t)
    f = residual(*ctx, *state, cfg.physics, cfg.time, cfg.freeze_phi_temperature)
    jm, pc = assemble_system(*ctx, *state, cfg.physics, cfg.time)
    return {"F": f.T, "Ax": jm.matvec_t(x).T, "Px": pc(x).T}


def gather_perturbed_step(gsolver, raw) -> dict:
    """Phase 26 (b)'s reference on phase 14's one-process gather solver, at
    perturbed_flow_state(raw): F, J x and P x (rcb_operator, x
    rcb_probe_vector), one adaptive step, and RCB_WITNESSES steps from the
    input times (1 + RCB_WITNESS_EPS N(0, 1)) (seeded): `spread`, each
    field's largest distance of a witness step from the step, is how far
    float32 roundoff of the input alone moves it."""
    import torch

    state = perturbed_flow_state(raw, "cuda", gsolver.dtype)
    op = rcb_operator(gsolver, state, rcb_probe_vector(raw.num_node, "cuda", gsolver.dtype))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    *new, stats = gsolver.step(*state)
    torch.cuda.synchronize()
    out = {"operator": {k: v.cpu() for k, v in op.items()}, "state": [t.cpu() for t in new],
           "newton": len(stats.rnorms), "krylov": stats.krylov_iters,
           "step_s": time.perf_counter() - t0, "spread": [0.0] * 18, "witness_krylov": [],
           "linear_rels": [float(v) for v in stats.linear_rels or ()]}
    for k in range(RCB_WITNESSES):
        gen = torch.Generator(device="cuda").manual_seed(SEED + k)
        noisy = [t * (1 + RCB_WITNESS_EPS * torch.randn(t.shape, generator=gen, device=t.device,
                                                        dtype=t.dtype)) for t in state]
        *w, wstats = gsolver.step(*noisy)
        out["spread"] = [max(a, b) for a, b in
                         zip(out["spread"], field_errs([t.cpu() for t in w], out["state"]))]
        out["witness_krylov"].append(wstats.krylov_iters)
    say(f"  one step from perturbed_flow_state (phase 26 (b)'s reference): {out['step_s']:.3f} s, "
        f"newton {out['newton']}, krylov {out['krylov']}, linear residuals "
        f"{fmt_list(out['linear_rels'])}; {RCB_WITNESSES} steps from the input x "
        f"(1 + {RCB_WITNESS_EPS:.0e} N(0, 1)): krylov {out['witness_krylov']}, each field's "
        f"largest distance {fmt_list(out['spread'])}")
    return out


def melt_source(mesh, cfg, step: int, device, dtype):
    """The laser source at the generalized-alpha level of `step` (1-based),
    t = (step - 1 + alpha_f) dt, as the CLI evaluates it."""
    import torch

    from dedflow_tpu_torch.app.scenarios import laser_source

    t_alpha = (step - 1 + cfg.time.alpha_f) * cfg.time.dt
    return torch.as_tensor(laser_source(cfg.physics.laser, mesh.xg, t_alpha), dtype=dtype,
                           device=device)


def perturbed_melt_state(mesh, cfg, device, dtype):
    """The melt-pool initial state with a seeded perturbation of dwg (a
    velocity for the tangents to convect with), advanced by one predict."""
    import numpy as np

    from dedflow_tpu_torch.app.scenarios import melt_pool_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.solver.newton import predict

    wg, dwgold, dwg = melt_pool_initial_state(mesh)
    dwg = dwg + 0.1 * np.random.default_rng(SEED).standard_normal(dwg.shape)
    wg, dwgold, dwg = state_from_numpy(wg, dwgold, dwg, device, dtype)
    return wg, dwgold, predict(dwg, cfg.time)


def melt_solver():
    """NSSolver on BASELINE config #3's box with the melt-pool scenario."""
    import torch

    from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    t0 = time.perf_counter()
    solver = NSSolver(box_mesh(*MELT_BOX), melt_pool_scenario_config(), device="cuda")
    torch.cuda.synchronize()
    if solver.fastpath != "lattice" or not solver.lctx.scalar_implicit:
        raise PhaseError(f"melt: fastpath {solver.fastpath!r}, expected the implicit lattice")
    return solver, time.perf_counter() - t0


def phase_melt_kernels(solver) -> tuple[list, dict]:
    """Phase 15: K1 with the laser source, K2 in its implicit mode (masked
    with the facet band, and unmasked) and K6 in its 33-row mode on the
    lattice's slab-major inputs, each against its plain version at the
    melt box; the three records and the melt system's timings."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import element_rows as er
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.krylov import gmres
    from dedflow_tpu_torch.solver.newton import assemble_system, residual
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
    from dedflow_tpu_torch.tools.timing import nbytes, time_ms
    from dedflow_tpu_torch.utils import nvcc

    cfg, mesh = solver.cfg, solver.mesh
    phys, scheme, lctx, mask_t = cfg.physics, cfg.time, solver.lctx, solver.mask_t
    wg, dwgold, dwg = perturbed_melt_state(mesh, cfg, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    src = melt_source(mesh, cfg, 1, solver.device, solver.dtype)
    n, nd = lctx.num_node, len(lctx.offsets)

    k1 = lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme, src)
    p1 = lambda: lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme, src)
    e1 = compare("K1 F volume, heat source", k1, p1, TOL_K1,
                 parts={"": lambda t: t, " [T row]": lambda t: t[5]})
    same1 = torch.equal(k1(), lat._reduce_residual(lctx, ek.res_rows_call(
        lat._residual_inputs(lctx, wa_t, dwa_t, src), phys, scheme)))
    say(f"  K1 fused with the source == K6's residual rows summed in the plain order, bit for "
        f"bit: {same1}")
    if not same1:
        raise PhaseError("K1 (source): the fused pass differs from the element rows in plain order")

    # K2 implicit: data (D, 16, N) and scal (2D, N) packed as one tensor
    pack = lambda d, sc: torch.cat([d.reshape(nd * 16, n), sc])
    parts = {f" data [{b}]": (lambda t, c=list(cs): t[: nd * 16].reshape(nd, 16, n)[:, c])
             for b, cs in VP_BLOCKS.items()}
    parts[" scal [phi-phi]"] = lambda t: t[nd * 16 :: 2]
    parts[" scal [T-T]"] = lambda t: t[nd * 16 + 1 :: 2]
    keep, add = keep_pc_rows(mask_t, solver.dtype), diag_add_rows(mask_t, solver.dtype)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, nd, keep)
    k2 = lambda: pack(*lat.jacobian_volume(lctx, wa_t, phys, scheme, keep, add, band, lo))
    p2 = lambda: pack(*lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, lo))
    e2 = compare("K2 implicit (masked)", k2, p2, TOL_K2, parts=parts)
    ones, zeros = torch.ones_like(keep), torch.zeros_like(add)
    e2 = max(e2, compare(
        "K2 implicit (unmasked)",
        lambda: pack(*lat.jacobian_volume(lctx, wa_t, phys, scheme, ones, zeros)),
        lambda: pack(*lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, ones, zeros)),
        TOL_K2, parts=parts,
    ))

    inp = lat._lhs_inputs(lctx, wa_t)  # (6, 33, N), the metric rows last
    if inp.shape != (6, 33, n):
        raise PhaseError(f"melt: lattice Jacobian inputs {tuple(inp.shape)}, expected (6, 33, N)")
    largs = ek.lhs_args(phys, scheme)
    k6 = lambda: ek.lhs_rows_call(inp, phys, scheme, scalar_implicit=True)
    p6 = lambda: er.lhs_rows(inp, scalar_implicit=True, **largs)
    e6 = compare("K6 33-row on the lattice inputs", k6, p6, TOL_K6,
                 parts=jacobian_blocks(n, implicit=True, slabs=6))

    data, scal = lat.jacobian_volume(lctx, wa_t, phys, scheme, keep, add, band, lo)
    out6 = torch.empty((6, n), dtype=torch.float32)
    out288 = torch.empty((6, 288, n), dtype=torch.float32)
    metric = lctx.res_geom[:, 13:19]  # what K2 reads of the residual geometry
    results = [
        finish(MELT_KERNELS[0][0], {"max_abs_err": e1}, k1, p1, 20, 5,
               nbytes(lctx.res_geom, wa_t, dwa_t, src, out6), op_count(p1)),
        finish(MELT_KERNELS[1][0], {"max_abs_err": e2}, k2, p2, 10, 3,
               nbytes(lctx.lhs_geom, metric, wa_t[:3], keep, add, band, data, scal), op_count(p2)),
        finish(MELT_KERNELS[2][0], {"max_abs_err": e6}, k6, p6, 10, 3,
               nbytes(inp, out288), op_count(p6)),
    ]
    libs = nvcc.load(["lattice_residual", "lattice_jacobian", "element_rows"])
    k1_regs = registers(libs["lattice_residual"], "residual_fused_kernel", "KuhnCells")
    say(f"  ptxas registers: K1 fused {k1_regs}, "
        f"K2 fused frozen "
        f"{registers(libs['lattice_jacobian'], 'jacobian_fused_kernelILb0E', 'KuhnPlanes')} "
        f"implicit {registers(libs['lattice_jacobian'], 'jacobian_fused_kernelILb1E', 'KuhnPlanes')}, "
        f"K6 33-row {registers(libs['element_rows'], 'lhs_rows_kernelILb1E')}")
    del inp, out288

    common = (lctx, solver.face_ctxs, mask_t, wg, dwgold, dwg, phys, scheme)
    f_ms = time_ms(lambda: residual(*common, cfg.freeze_phi_temperature, source=src), 10)
    j_ms = time_ms(lambda: assemble_system(*common, scalar_implicit=True), 5)
    jm, pc = assemble_system(*common, scalar_implicit=True)
    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, n), generator=gen, device=solver.device, dtype=solver.dtype)
    spmv_ms = time_ms(lambda: dia_matvec(jm.data, jm.scal, x, lctx.offsets), 100)
    f = residual(*common, cfg.freeze_phi_temperature, source=src)
    gmres120 = lambda: gmres(jm.matvec_t, f, maxit=120, atol=0.0, rtol=0.0, pc=pc)
    gmres120()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = gmres120()
    torch.cuda.synchronize()
    times = {"F_ms": f_ms, "J_PC_ms": j_ms, "SpMV_ms": spmv_ms,
             "GMRES120_s": time.perf_counter() - t0, "GMRES120_iters": sol.iters}
    return results, times


def phase_melt_slice() -> dict:
    """Phase 16: the melt pool at box 12 on the three tiers, one
    step_fixed(num_newton=2) with the laser source: card float32 against
    CPU float64, TOL_SLICE. Each card step runs with its tier's launch
    counters set to 0 just before and read just after (the column K6 / K5
    Jacobian, K9's staging pass and the column K4 must stay at 0, and on
    the gather tier K8's staging pass, on the WinELL tier K10's residual
    instance without the source); returns {tier: launches}."""
    import dataclasses

    import torch

    from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver
    from dedflow_tpu_torch.sparse import win_gather as wg
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_staged
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_staged

    by_map = wg.win_gather.instances
    box = box_mesh(*SLICE_BOX)
    converted = dataclasses.replace(box, lattice=None)
    converted = reorder_mesh(converted, rcm_order(converted.ien, converted.num_node))
    tiers = {
        "lattice": (box, "auto", (lat.residual_volume, lat.jacobian_volume, dia_matvec),
                    "K1/K2/K3"),
        "winell": (converted, "winell", (wg.win_gather, ek.res_rows_call, ek.lhs_rows_staged,
                                         winell_matvec, stream_reduce, ring_reduce_staged,
                                         by_map[wg.RESIDUAL_SOURCE_MAP], by_map[wg.JACOBIAN_MAP]),
                   "K10/K6res/K6staged/K7/K8/K9sum/K10source/K10jac"),
        "gather": (box, "gather", (ek.ns_residual_gather_staged, ek.ns_lhs_gather_staged,
                                   winell_matvec, stream_reduce_staged, ring_reduce_staged),
                   "K4staged/K5staged/K7/K8sum/K9sum"),
    }
    # the entries off the paths: the irregular tiers' column K6 / K5 and K9
    # with its staging pass, the column K4; on the gather tier also K8 with
    # its staging pass (the WinELL tier's residual reduce), on the WinELL
    # tier K10's residual instance without the source (every residual there
    # takes the laser's)
    absent = (ek.lhs_rows_call, ek.ns_lhs_gather, ring_reduce, ek.ns_residual_gather)
    launches = {}
    for tier, (mesh, mode, counters, label) in tiers.items():
        absent_here = absent + {"gather": (stream_reduce,),
                                "winell": (by_map[wg.RESIDUAL_MAP],)}.get(tier, ())
        cfg = melt_pool_scenario_config(use_lattice=mode)
        outs = []
        for device in ("cuda", "cpu"):
            solver = NSSolver(mesh, cfg, device=device)
            if solver.fastpath != tier or not solver.face_ctxs:
                raise PhaseError(f"melt slice: fastpath {solver.fastpath!r}, expected {tier!r}")
            state = perturbed_melt_state(mesh, cfg, solver.device, solver.dtype)
            src = melt_source(mesh, cfg, 1, solver.device, solver.dtype)
            if device == "cuda":
                torch.cuda.synchronize()
                for c in (*counters, *absent_here):
                    c.launches = 0
            outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2, source=src)])
            if device == "cuda":
                torch.cuda.synchronize()
                launches[tier] = [c.launches for c in counters]
                if any(c.launches for c in absent_here):
                    raise PhaseError(f"melt slice {tier}: an entry off the path was launched: "
                                     f"{[c.launches for c in absent_here]}")
        worst = 0.0
        for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"melt slice {tier}: non-finite {name} on the card")
            _, rel = rel_err(g, r)
            worst = max(worst, rel)
        _, rel_t = rel_err(outs[0][0][:, 5], outs[1][0][:, 5])
        say(f"  {tier}: card f32 vs cpu f64 rel={worst:.3e} (T {rel_t:.3e}); launches {label} = "
            f"{launches[tier]}")
        check(f"melt slice {tier}", max(worst, rel_t), TOL_SLICE)
        if tier == "winell" and (launches[tier][6:8] != launches[tier][1:3]
                                 or launches[tier][0] != sum(launches[tier][6:8])):
            raise PhaseError(f"melt slice winell: K10 launches {launches[tier][0]} (with the "
                             f"source {launches[tier][6]}, jacobian {launches[tier][7]}), not one "
                             f"per K6 launch of its map ({launches[tier][1]} + "
                             f"{launches[tier][2]})")
        if min(launches[tier]) <= 0:
            raise PhaseError(f"melt slice {tier}: a kernel of the path was not launched")
    return launches


def phase_melt_main(solver) -> dict:
    """Phase 17: the melt-pool main path: solver.step twice (adaptive) and
    step_fixed(2) three times, each with the laser source at its
    generalized-alpha level, from the scenario's initial state, the launch
    counters set to 0 just before and read just after; then the checks of
    tests/test_melt_pool.py (heat deposited, the hottest node within 3
    laser radii of the beam's mid-run centre) and step 1 repeated
    (bit-identical states and Krylov counts)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import melt_pool_initial_state
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    mesh, cfg = solver.mesh, solver.cfg
    counters = (lat.residual_volume, lat.jacobian_volume, dia_matvec)
    state0 = state_from_numpy(*melt_pool_initial_state(mesh), solver.device, solver.dtype)
    nsteps = sum(MELT_STEPS)
    srcs = [melt_source(mesh, cfg, k, solver.device, solver.dtype) for k in range(1, nsteps + 1)]
    state, first = state0, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    walls, newton, krylov = [], [], []
    for step in range(1, nsteps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step <= MELT_STEPS[0]:
            *state, stats = solver.step(*state, source=srcs[step - 1])
            newton.append(len(stats.rnorms))
            krylov.append(stats.krylov_iters)
        else:
            state = solver.step_fixed(*state, num_newton=MELT_FIXED_NEWTON, source=srcs[step - 1])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        first = first or (state, krylov[0])
        t_max = float(state[0][:, 5].max())
        say(f"  step {step} ({'adaptive' if step <= MELT_STEPS[0] else 'step_fixed(2)'}): "
            f"wall_s={walls[-1]:.4f} t_max={t_max:.6f}"
            + (f" newton={newton[-1]} krylov={krylov[-1]} converged={stats.converged} "
               f"field_norms={[float(v) for v in stats.rnorms[-1]]}" if step <= MELT_STEPS[0] else "")
            + f" launches K1/K2/K3 so far={[c.launches for c in counters]}")
        if not all(bool(torch.isfinite(t).all()) for t in state):
            raise PhaseError(f"melt main: non-finite state at step {step}")
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated()
    temp = state[0][:, 5].cpu().numpy()
    laser, dt = cfg.physics.laser, cfg.time.dt
    hot = mesh.xg[int(np.argmax(temp))]
    c0 = np.asarray(laser.start) + np.asarray(laser.velocity) * nsteps * dt / 2
    dist = float(np.linalg.norm(hot - c0))
    say(f"  launches K1/K2/K3 = {launches}; peak memory {peak / 2**30:.3f} GiB; t_max "
        f"{temp.max():.6f} at {hot.tolist()}, {dist:.4f} from the beam's mid-run centre "
        f"(3 radii = {3 * laser.radius:.3f})")
    if min(launches) <= 0:
        raise PhaseError(f"melt main: a kernel of the path was not launched: {launches}")
    if not temp.max() > 0 or not dist < 3 * laser.radius:
        raise PhaseError("melt main: no heat deposited, or the hottest node is off the beam")
    *again, stats = solver.step(*state0, source=srcs[0])
    same = all(torch.equal(a, b) for a, b in zip(again, first[0]))
    say(f"  step 1 repeated: bit-identical states {same}, krylov {stats.krylov_iters}")
    if not same or stats.krylov_iters != first[1]:
        raise PhaseError("melt main: a repeated step differs from the first run")
    fixed = lambda: solver.step_fixed(*state0, num_newton=MELT_FIXED_NEWTON, source=srcs[0])
    say(f"  one step_fixed({MELT_FIXED_NEWTON}) under torch.profiler: {busy_share(fixed)}")
    return {"launches": launches, "step_s": walls, "newton": newton, "krylov": krylov,
            "t_max": float(temp.max()), "peak_bytes": peak}


def probe_check(label: str, kernel, plain, exact: bool) -> float:
    """Run a probe kernel twice and its plain version once; the copies and
    gathers must equal it bit for bit (both runs), the reduce's outputs be
    within TOL_K12_REDUCE of it. Returns the max abs error."""
    import torch

    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise PhaseError(f"{label}: non-finite kernel output")
    worst = 0.0
    for out in (got, again):
        err, rel = rel_err(out, ref)
        worst = max(worst, err)
        if exact and not torch.equal(out, ref):
            raise PhaseError(f"{label}: differs from its plain version (max abs {err:.3e})")
        if not exact:
            check(label, rel, TOL_K12_REDUCE)
    say(f"  {label}: max_abs_err={worst:.3e} ("
        + ("bit for bit)" if exact else f"rel {rel:.3e}, tol {TOL_K12_REDUCE:.0e})"))
    return worst


def phase_probes() -> list:
    """K12 on tools/gmicro.py's (8, 2**23) stream and K13 at
    tools/gather_probe.py's W = 4096 and 65,536 elements. First each
    kernel is held against its plain version and its library call against
    the kernel, on the tools' ids; the window gathers and the segment
    reduce also on ids over their full range,
    [0, 512 * 5). Then the probes' own path: the entry points' runs
    (gmicro.run, gather_probe.run) at those sizes, with the count of every
    probe wrapper set to 0 just before and read just after; each kernel
    must have been launched there, and the runs' records account for every
    launch. Returns (name, source, replaced kernel, record) per kernel and
    idiom, with the runs' times."""
    import torch

    from dedflow_tpu_torch.tools import gather_probe as tgp
    from dedflow_tpu_torch.tools import gmicro as tgm

    def held(label, p) -> float:
        err = probe_check(label, p.kernel, p.plain, p.exact)
        ref = p.library[1]()
        _, rel = rel_err(p.library[0]().reshape(ref.shape), ref)
        if not (rel == 0.0 if p.exact else rel <= TOL_K12_REDUCE):
            raise PhaseError(f"{label}: library call differs from the kernel (rel {rel:.3e})")
        return err

    dev = torch.device("cuda")
    x, idx = tgm.inputs(PROBE_N, dev, SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    full = torch.randint(0, 512 * 5, (8, PROBE_N), generator=gen, device=dev, dtype=torch.int32)
    for nw in tgm.NWINS:
        probe_check(f"K12 window gather nwin={nw}, full-range ids",
                    lambda nw=nw: tgm.window_gather(x, full, nw),
                    lambda nw=nw: tgm.window_gather_plain(x, full, nw), True)
    for hb in REDUCE_HBS:  # rows, then bins: every hb, both id sets
        for tag, ids in (("full-range ids", full), ("the tool's ids", idx)):
            probe_check(f"K12 segment reduce hb={hb}, {tag}",
                        lambda hb=hb, ids=ids: tgm.segment_reduce(x, ids, hb),
                        lambda hb=hb, ids=ids: tgm.segment_reduce_plain(x, ids, hb), False)
    del full
    errs = {p.name: held(f"K12 {p.name} [{p.what}]", p) for p in tgm.probes(x, idx)}
    del x, idx
    idx, win = tgp.inputs(PROBE_W, dev, SEED)
    errs |= {p.name: held(f"K13 {p.what}", p) for p in tgp.probes(idx, win)}
    del idx, win
    counters = (tgm.copy2, tgm.lane_gather, tgm.window_gather, tgm.segment_reduce,
                tgp.element_gather)
    for c in counters:
        c.launches = 0
    k12 = tgm.run(PROBE_N, dev)
    k13 = tgp.run(PROBE_W, dev)
    counts = {c.__name__: c.launches for c in counters}
    say(f"  launches on the probes' runs: {counts}")
    for name, n in counts.items():
        recorded = sum(r["launches"] for r in k12 + k13 if r["counter"] == name)
        if n <= 0 or n != recorded:
            raise PhaseError(f"probes: {name} launched {n} times on the runs, {recorded} "
                             f"in their records")
    keys = ("launches", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    out = []
    for r in k12 + k13:
        if r["launches"] <= 0:
            raise PhaseError(f"probes: {r['name']} was not launched on its run")
        rec = {k: r[k] for k in keys} | {"max_abs_err": max(r["max_abs_err"], errs[r["name"]])}
        if r["counter"] == "element_gather":
            line = 60 if r["name"] == "global" else 76
            out.append((f"K13 {r['what']}", "dedflow_tpu_torch/csrc/gather_probe.cu",
                        f"tools/gather_probe.py:{line}", rec))
        else:
            out.append((f"K12 {r['name']} [{r['what']}]", "dedflow_tpu_torch/csrc/gmicro.cu",
                        "tools/gmicro.py:47", rec))
    return out


# ---------------------------------------------------------------------------
# phase 19: the Krylov options (pc "simple" / "mg", precision "f64" / "ir",
# the lagged Jacobian)

PCS = ("fieldsplit", "simple", "mg")
IR_PC = "mg"  # the box-55 refinement's inner preconditioner
# K3 and K7 in float64: sums of ~60 / ~64 products a row against the plain
# version's order, at float64 roundoff, per equation.
TOL_F64 = 1e-12
# The refined solves reach the BASELINE.md bar (1e-10 relative linear
# residual) on the box-12 slice.
IR_BAR = 1e-10
KRYLOV_KERNELS = (
    ("K3 dia spmv (f64)", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:56"),
    ("K7 winell spmv (f64)", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:55"),
)


def with_krylov(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, krylov=dataclasses.replace(cfg.krylov, **kw))


class RefineSpy:
    """Records every iterative refinement the solver runs (cycles, inner
    iterations, final relative residual) while it is installed in
    solver.newton; the solve itself is unchanged."""

    def __init__(self):
        self.runs = []

    def __enter__(self):
        from dedflow_tpu_torch.solver import newton

        self.orig = newton.gmres_ir_device

        def spy(*a, **k):
            out = self.orig(*a, **k)
            self.runs.append((out.cycles, out.inner_iters, float(out.rel_residual)))
            return out

        newton.gmres_ir_device = spy
        return self

    def __exit__(self, *exc):
        from dedflow_tpu_torch.solver import newton

        newton.gmres_ir_device = self.orig


def cuda_events(fn) -> int:
    """Device operations (kernels, copies, sets) one call of `fn` queues,
    by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def pc_record(jm, pc_fn, n: int) -> dict:
    """A preconditioner's set-up (pc_fn(jm)) and apply on a seeded (6, n)
    vector: ms as the host paces the launches (what GMRES sees) and as the
    card runs them queued, and its device operations a call."""
    import torch

    from dedflow_tpu_torch.tools.timing import time_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((6, n), generator=gen, device="cuda", dtype=torch.float32)
    pc = pc_fn(jm)
    y = pc(x)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(y).all()):
        raise PhaseError("krylov: a preconditioner apply is not finite")
    return {
        "setup_ms": time_ms(lambda: pc_fn(jm), 3, queue_ahead=False),
        "apply_ms": time_ms(lambda: pc(x), 10, queue_ahead=False),
        "apply_device_ms": time_ms(lambda: pc(x), 10),
        "apply_launches": cuda_events(lambda: pc(x)),
    }


def lattice_pc_setup(name: str, dims):
    from dedflow_tpu_torch.solver.mg import MGSIMPLEPCT
    from dedflow_tpu_torch.solver.pc import SIMPLEPCT, NSFieldSplitPCT

    return {"fieldsplit": lambda jm: NSFieldSplitPCT.from_diag_rows(jm.diag_rows()),
            "simple": SIMPLEPCT.from_matrix,
            "mg": lambda jm: MGSIMPLEPCT.from_matrix(jm, dims)}[name]


def krylov_step(solver, counters, label: str, repeat: bool = False) -> dict:
    """One adaptive step of `solver` from the reference initial state with
    the launch counts set to 0 just before and read just after (each must
    be positive), its wall time, counts and peak memory; with `repeat` the
    step again from the same state, which must be bit-identical."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy

    state0 = state_from_numpy(*reference_initial_state(solver.mesh), "cuda", solver.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    *state, stats = solver.step(*state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    rec = {"step_s": wall, "newton": len(stats.rnorms), "krylov": stats.krylov_iters,
           "converged": stats.converged, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches}
    say(f"  {label}: step_s={wall:.4f} newton={rec['newton']} krylov={stats.krylov_iters} "
        f"converged={stats.converged} peak={rec['peak_gib']:.3f} GiB launches "
        f"{[c.__name__ for c in counters]}={launches}")
    if not all(math.isfinite(float(v)) for v in stats.rnorms[-1]) or not all(
            bool(torch.isfinite(t).all()) for t in state):
        raise PhaseError(f"krylov {label}: non-finite step")
    if min(launches) <= 0:
        raise PhaseError(f"krylov {label}: a kernel of the path was not launched: {launches}")
    if repeat:
        *again, astats = solver.step(*state0)
        same = all(torch.equal(a, b) for a, b in zip(again, state))
        say(f"  {label} repeated: bit-identical states {same}, krylov {astats.krylov_iters}")
        if not same or astats.krylov_iters != stats.krylov_iters:
            raise PhaseError(f"krylov {label}: a repeated step differs from the first")
        rec["repeat_bit_identical"] = same
    return rec


def ir_step(solver, counters, label: str) -> dict:
    """step_fixed(1) of `solver` (precision "ir") from the reference
    initial state with the launch counts set to 0 just before and read just after, and
    the refinement it ran (RefineSpy)."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_initial_state
    from dedflow_tpu_torch.interop import state_from_numpy

    state0 = state_from_numpy(*reference_initial_state(solver.mesh), "cuda", solver.dtype)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    with RefineSpy() as spy:
        t0 = time.perf_counter()
        out = solver.step_fixed(*state0, num_newton=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    ((cycles, inner, rel),) = spy.runs
    say(f"  {label}: step_fixed(1) s={wall:.4f} cycles={cycles} inner_iters={inner} "
        f"rel_linear_residual={rel:.3e} launches {[c.__name__ for c in counters]}={launches}")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise PhaseError(f"krylov {label}: non-finite step")
    if min(launches) <= 0:
        raise PhaseError(f"krylov {label}: a kernel of the path was not launched: {launches}")
    return {"step_s": wall, "cycles": cycles, "inner_iters": inner, "rel": rel,
            "launches": launches}


def f64_record(label: str, kern, plain, nbytes_, counted, library, counter) -> dict:
    """A float64 kernel against its plain version per equation (TOL_F64),
    twice bit-identical, then finish()'s timings (operations at the FP64
    rate); the launches of the comparison are not counted."""
    from dedflow_tpu_torch.tools.timing import FP64_OPS_PER_S

    before = counter.launches
    err = compare(label, kern, plain, TOL_F64,
                  parts={" [u rows]": lambda t: t[:3], " [p row]": lambda t: t[3:4],
                         " [phi,T rows]": lambda t: t[4:]})
    rec = finish(label, {"max_abs_err": err}, kern, plain, 50, 5, nbytes_, counted,
                 library=library, ops_per_s=FP64_OPS_PER_S)
    counter.launches = before
    return rec


def krylov_slices() -> dict:
    """Box 12, card float32 against CPU float64, one step_fixed(2) each:
    pc simple and mg on the lattice, mg (AMG) on the converted box with
    RCM (WinELL), simple on the gather tier, the lagged Jacobian (simple)
    and precision "ir" (mg) on the lattice, whose every refined solve must
    reach IR_BAR."""
    import dataclasses

    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.mesh.reorder import rcm_order, reorder_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    box = box_mesh(*SLICE_BOX)
    conv = dataclasses.replace(box, lattice=None)
    conv = reorder_mesh(conv, rcm_order(conv.ien, conv.num_node))
    ref = reference_scenario_config()
    cases = {
        "lattice simple": (box, with_krylov(ref, pc="simple"), "lattice"),
        "lattice mg": (box, with_krylov(ref, pc="mg"), "lattice"),
        "winell mg (AMG)": (conv, with_krylov(reference_scenario_config(use_lattice="winell"),
                                              pc="mg"), "winell"),
        "gather simple": (box, with_krylov(reference_scenario_config(use_lattice="gather"),
                                           pc="simple"), "gather"),
        "lattice simple, lagged J": (box, dataclasses.replace(
            with_krylov(ref, pc="simple"),
            newton=dataclasses.replace(ref.newton, lag_jacobian=True)), "lattice"),
        "lattice mg, ir": (box, with_krylov(ref, pc="mg", precision="ir"), "lattice"),
    }
    out = {}
    for label, (mesh, cfg, tier) in cases.items():
        outs, refines = [], []
        for device in ("cuda", "cpu"):
            solver = NSSolver(mesh, cfg, device=device)
            if solver.fastpath != tier:
                raise PhaseError(f"krylov slice {label}: fastpath {solver.fastpath!r}")
            state = perturbed_state(mesh, device, solver.dtype)
            with RefineSpy() as spy:
                outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
            refines.append(spy.runs)
        worst = 0.0
        for g, r in zip(*outs):
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"krylov slice {label}: non-finite state on the card")
            worst = max(worst, rel_err(g, r)[1])
        line = f"  slice {label}: card f32 vs cpu f64 rel={worst:.3e} (tol {TOL_SLICE:.0e})"
        if cfg.krylov.precision == "ir":
            rels = [r for _, _, r in refines[0]]
            line += (f"; card refinements (cycles, inner, rel) {refines[0]}, "
                     f"max rel {max(rels):.3e} (bar {IR_BAR:.0e})")
            if not max(rels) <= IR_BAR:
                raise PhaseError(f"krylov slice {label}: a refined solve ended at {max(rels):.3e}")
        say(line)
        check(f"krylov slice {label}", worst, TOL_SLICE)
        out[label] = worst
    return out


def phase_krylov(rcm, raw) -> tuple[list, dict]:
    """Phase 19: the Krylov options on the card. Box 55, reference scenario:
    one adaptive step for each of PCS, with the preconditioner's set-up and
    apply (ms, device operations), then precision "ir" (IR_PC) as one
    step_fixed(1), and K3's float64 mode on that mesh's J. Phase 6's RCM
    Delaunay mesh with pc mg (AMG), one step repeated bit-identical, its
    step_fixed(1) with "ir", and K7's float64 mode on its J. Phase 12's
    unordered Delaunay mesh on the gather tier with pc simple, one step.
    Then the box-12 slices (krylov_slices). Returns the two float64 kernel
    records (KRYLOV_KERNELS' order, with their main-path launches) and the
    summary."""
    import copy

    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.amg import AMGSchurPCT
    from dedflow_tpu_torch.solver.newton import NSSolver, assemble_system
    from dedflow_tpu_torch.solver.pc import SIMPLEPC
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_f64, dia_matvec_plain
    from dedflow_tpu_torch.sparse.win_gather import win_gather
    from dedflow_tpu_torch.sparse.win_kernels import (
        winell_matvec,
        winell_matvec_f64,
        winell_matvec_plain,
    )
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce_staged
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_staged
    from dedflow_tpu_torch.sparse.winell import COMP2WIN
    from dedflow_tpu_torch.tools.timing import nbytes

    summary = {}
    ref = reference_scenario_config()
    lattice_counters = (lat.residual_volume, lat.jacobian_volume, dia_matvec)
    mesh = box_mesh(*FULL_BOX)
    for name in PCS:
        t0 = time.perf_counter()
        solver = NSSolver(mesh, with_krylov(ref, pc=name), device="cuda")
        setup = time.perf_counter() - t0
        rec = krylov_step(solver, lattice_counters, f"box 55 pc {name}", repeat=name == "mg")
        wg, dwgold, dwg = perturbed_state(mesh, "cuda", solver.dtype)
        wa, dwa = alpha_states(wg, dwgold, dwg, ref.time)
        jm = lat.assemble_jacobian_t(solver.lctx, solver.face_ctxs, solver.mask_t, wa, dwa,
                                     ref.physics, ref.time)
        rec.update(pc_record(jm, lattice_pc_setup(name, solver.lctx.dims), solver.lctx.num_node))
        rec["solver_setup_s"] = setup
        say(f"  box 55 pc {name}: pc setup_ms={rec['setup_ms']:.3f} apply_ms={rec['apply_ms']:.3f} "
            f"(queued on the card {rec['apply_device_ms']:.3f}) device ops an apply="
            f"{rec['apply_launches']}; solver set-up {setup:.2f} s")
        summary[f"box55 {name}"] = rec
        del solver
    # precision "ir" on the same mesh; K3's float64 mode on its J
    solver = NSSolver(mesh, with_krylov(ref, pc=IR_PC, precision="ir"), device="cuda")
    summary["box55 ir"] = ir_step(solver, (*lattice_counters, dia_matvec_f64),
                                  f"box 55 pc {IR_PC}, precision ir")
    k3_launches = summary["box55 ir"]["launches"][-1]
    d64, s64 = jm.data.double(), jm.scal.double()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x64 = torch.randn((6, jm.num_rows), generator=gen, device="cuda", dtype=torch.float64)
    offs, n = jm.offsets, jm.num_rows
    pieces = []
    for k, o in enumerate(offs):
        r = torch.arange(max(0, -o), min(n, n - o), device="cuda")
        by_comp = {c: d64[k, c, r] for c in range(16)}
        by_comp.update({16: s64[2 * k, r], 17: s64[2 * k + 1, r]})
        pieces.append((r, r + o, by_comp))
    csr = block_csr(n, pieces)
    xflat = x64.reshape(-1)
    k3 = lambda: dia_matvec(d64, s64, x64, offs)
    p3 = lambda: dia_matvec_plain(d64, s64, x64, offs)
    r3 = f64_record(KRYLOV_KERNELS[0][0], k3, p3, nbytes(d64, s64, x64, x64), op_count(p3),
                    (lambda: csr @ xflat, k3()), dia_matvec_f64)
    del solver, jm, d64, s64, csr, pieces

    # WinELL: phase 6's RCM Delaunay mesh with AMG
    cfg_w = with_krylov(reference_scenario_config(bcs=(), pin_pressure=True), pc="mg")
    t0 = time.perf_counter()
    amg_s = []
    orig = wa_.build_win_amg

    def timed_amg(*a, **k):
        t = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        amg_s.append(time.perf_counter() - t)
        return out

    wa_.build_win_amg = timed_amg
    try:
        wsolver = NSSolver(rcm, cfg_w, device="cuda")
    finally:
        wa_.build_win_amg = orig
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if wsolver.fastpath != "winell" or wsolver.wctx.amg_idx is None:
        raise PhaseError("krylov: the RCM Delaunay solver has no AMG plan on the winell tier")
    idx = wsolver.wctx.amg_idx
    say(f"  winell pc mg: solver set-up {setup:.2f} s, of it the AMG plan {amg_s[0]:.2f} s "
        f"(levels {list(idx.ns)}, coarse entries {list(idx.ecs)})")
    w_counters = (ek.res_rows_call, ek.lhs_rows_staged, winell_matvec, stream_reduce,
                  ring_reduce_staged, win_gather)
    rec = krylov_step(wsolver, w_counters, "winell pc mg (AMG)", repeat=True)
    wg, dwgold, dwg = perturbed_state(rcm, "cuda", wsolver.dtype)
    wm, _ = assemble_system(wsolver.wctx, wsolver.face_ctxs, wsolver.mask_t, wg, dwgold, dwg,
                            cfg_w.physics, cfg_w.time)
    rec.update(pc_record(
        wm, lambda m: AMGSchurPCT.from_winell(m, idx, wsolver.wctx.amg_eon), rcm.num_node))
    rec.update(solver_setup_s=setup, amg_plan_s=amg_s[0])
    say(f"  winell pc mg: pc setup_ms={rec['setup_ms']:.3f} apply_ms={rec['apply_ms']:.3f} "
        f"(queued {rec['apply_device_ms']:.3f}) device ops an apply={rec['apply_launches']}")
    summary["winell mg"] = rec
    wir = copy.copy(wsolver)  # the same contexts and AMG plan, precision "ir"
    wir.cfg = with_krylov(cfg_w, precision="ir")
    summary["winell ir"] = ir_step(wir, (winell_matvec, winell_matvec_f64), "winell pc mg, precision ir")
    k7_launches = summary["winell ir"]["launches"][-1]
    m64 = type(wm)(vals=wm.vals.double(), plan=wm.plan)
    xw = torch.randn((6, rcm.num_node), generator=gen, device="cuda", dtype=torch.float64)
    plan = wm.plan
    csrw = block_csr(rcm.num_node, [(plan.grow_t.long(), plan.col_t.long(),
                                     {c: m64.vals[int(COMP2WIN[c])] for c in range(18)})])
    xwf = xw.reshape(-1)
    k7 = lambda: winell_matvec(m64, xw)
    p7 = lambda: winell_matvec_plain(m64, xw)
    r7 = f64_record(KRYLOV_KERNELS[1][0], k7, p7,
                    nbytes(m64.vals, plan.col_t, plan.row_ptr_t, xw, xw), op_count(p7),
                    (lambda: csrw @ xwf, k7()), winell_matvec_f64)
    del wsolver, wir, wm, m64, csrw

    # the gather tier (phase 12's unordered mesh), pc simple
    t0 = time.perf_counter()
    gsolver = NSSolver(raw, with_krylov(reference_scenario_config(**GATHER_CONFIG), pc="simple"),
                       device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if gsolver.fastpath != "gather":
        raise PhaseError(f"krylov: gather fastpath {gsolver.fastpath!r}")
    g_counters = (ek.ns_residual_gather_staged, ek.ns_lhs_gather_staged, winell_matvec,
                  stream_reduce_staged, ring_reduce_staged)
    rec = krylov_step(gsolver, g_counters, "gather pc simple")
    wg, dwgold, dwg = perturbed_state(raw, "cuda", gsolver.dtype)
    gm, _ = assemble_system(gsolver.gctx, gsolver.face_ctxs, gsolver.mask_t, wg, dwgold, dwg,
                            gsolver.cfg.physics, gsolver.cfg.time)
    rec.update(pc_record(gm, SIMPLEPC.from_matrix, raw.num_node))
    rec["solver_setup_s"] = setup
    say(f"  gather pc simple: pc setup_ms={rec['setup_ms']:.3f} apply_ms={rec['apply_ms']:.3f} "
        f"(queued {rec['apply_device_ms']:.3f}) device ops an apply={rec['apply_launches']}; "
        f"solver set-up {setup:.2f} s")
    summary["gather simple"] = rec
    del gsolver, gm

    summary["slices"] = krylov_slices()
    return [r3 | {"launches": k3_launches}, r7 | {"launches": k7_launches}], summary


# ---------------------------------------------------------------------------
# phase 20: mesh files and the translation-class tier (ROADMAP A10): K1c /
# K2c (any table of up to 8 slabs, csrc/lattice_classes.cu) and K3 past the
# Kuhn lattice's 15 planes

CLASS_KERNELS = (
    ("K1 lattice residual (classes, one pass)", "dedflow_tpu_torch/csrc/lattice_residual.cu",
     "dedflow_tpu/fem/lattice.py:779"),
    ("K2 lattice jacobian (classes, one pass)", "dedflow_tpu_torch/csrc/lattice_jacobian.cu",
     "dedflow_tpu/fem/lattice.py:835"),
    ("K2 lattice jacobian (classes, one pass, implicit)",
     "dedflow_tpu_torch/csrc/lattice_jacobian.cu", "dedflow_tpu/fem/pallas_kernels.py:544"),
    ("K1 lattice residual (classes, two passes)", "dedflow_tpu_torch/csrc/lattice_classes.cu",
     "dedflow_tpu/fem/lattice.py:779"),
    ("K2 lattice jacobian (classes, two passes)", "dedflow_tpu_torch/csrc/lattice_classes.cu",
     "dedflow_tpu/fem/lattice.py:835"),
    ("K2 lattice jacobian (classes, two passes, implicit)",
     "dedflow_tpu_torch/csrc/lattice_classes.cu", "dedflow_tpu/fem/pallas_kernels.py:544"),
    ("K3 dia spmv (D > 16)", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:56"),
)
# A float32 GMRES crosses its rtol at another iteration than a float64 one
# now and then, kernels or not. Where the card's Krylov count of a slice
# differs from the float64 step's, plain float32 steps on the CPU witness
# it: on the same input and on copies perturbed by SLICE_F32_EPS relative
# (the size of the kernels' agreement with their plain versions), at most
# SLICE_F32_RUNS of them.
SLICE_F32_EPS = 1e-6
SLICE_F32_RUNS = 64


def l_shaped_config():
    """The reference scenario on mesh.gen.l_shaped_mesh: its BCs on the box
    sides that remain, every component of the nodes no element touches
    (group 7) held."""
    import dataclasses

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.config import BCSpec

    ref = reference_scenario_config()
    return dataclasses.replace(ref, bcs=ref.bcs + (BCSpec(7, strong_components=(0, 1, 2, 3, 4,
                                                                              5)),))


def class_solver(mesh, cfg, tier: str, label: str):
    """NSSolver on the card for a converted-mesh variant, on `tier`, with no
    fused tables; (solver, set-up seconds)."""
    import torch

    from dedflow_tpu_torch.solver.newton import NSSolver

    t0 = time.perf_counter()
    solver = NSSolver(mesh, cfg, device="cuda")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if solver.fastpath != tier or solver.lctx.fused is not None or solver.lctx.grid is None:
        raise PhaseError(f"classes {label}: fastpath {solver.fastpath!r} (expected {tier!r}), "
                         f"fused tables {solver.lctx.fused is not None}, node grid "
                         f"{solver.lctx.grid is not None}")
    return solver, setup


def in_turns(label: str, one, two, reps: int) -> dict:
    """The one-pass and the two-pass entry timed in turns on the same
    inputs (two, one, one, two)."""
    from dedflow_tpu_torch.tools.timing import time_ms

    t1 = time_ms(two, reps)
    o1, o2 = time_ms(one, reps), time_ms(one, reps)
    t2 = time_ms(two, reps)
    say(f"  {label} in turns: one pass {o1:.4f}, {o2:.4f} ms; two passes {t1:.4f}, {t2:.4f} ms")
    return {"one_pass_ms": [o1, o2], "two_pass_ms": [t1, t2]}


def class_kernel_records(solver, label: str) -> tuple[list, dict]:
    """K1c (no source) and K2c frozen (masked with the facet band, and
    unmasked) on `solver`'s context at its size: the one-pass kernels its
    table routes to (placed on a node grid) and the two-pass entries, each
    against its plain version per equation / vel/p block (TOL_K1 /
    TOL_K2), timed against it with its bound (K1's and K2's function), and
    the two routes timed in turns. Returns the records (one-pass K1c, K2c,
    two-pass K1c, K2c) and the turns."""
    import torch

    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
    from dedflow_tpu_torch.tools.timing import nbytes

    phys, scheme, lctx, mask_t = solver.cfg.physics, solver.cfg.time, solver.lctx, solver.mask_t
    if lctx.grid is None:
        raise PhaseError(f"classes {label}: the table did not place on a node grid")
    wg, dwgold, dwg = perturbed_state(solver.mesh, "cuda", solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    wa_t, dwa_t = wa.T.contiguous(), dwa.T.contiguous()
    n, nd = lctx.num_node, len(lctx.offsets)
    by_eq = reduce_parts()[0]
    k1 = lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme)
    t1 = lambda: lat.residual_volume_two_pass(lctx, wa_t, dwa_t, phys, scheme)
    p1 = lambda: lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme)
    before = lat.residual_volume_classes.launches
    e1 = compare(f"K1c F volume (one pass) {label}", k1, p1, TOL_K1, parts=by_eq)
    if lat.residual_volume_classes.launches == before:
        raise PhaseError(f"classes {label}: K1's wrapper did not reach the one-pass K1c")
    e1t = compare(f"K1c F volume (two passes) {label}", t1, p1, TOL_K1, parts=by_eq)
    same = torch.equal(k1(), t1())
    say(f"  K1c {label}: one pass == two passes bit for bit: {same}")
    keep, add = keep_pc_rows(mask_t, solver.dtype), diag_add_rows(mask_t, solver.dtype)
    band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, phys, scheme, nd, keep)
    keep16, add16 = keep[:16].contiguous(), add[:16].contiguous()
    vp = {f" [{b}]": (lambda t, c=list(cs): t[:, c]) for b, cs in VP_BLOCKS.items()}
    ones, zeros = torch.ones_like(keep16), torch.zeros_like(add16)
    p2 = lambda: lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep16, add16, band, lo)
    errs = {}
    for route, fn in (("one pass", lat.jacobian_volume),
                      ("two passes", lat.jacobian_volume_two_pass)):
        errs[route] = max(
            compare(f"K2c data (masked, {route}) {label}",
                    lambda: fn(lctx, wa_t, phys, scheme, keep16, add16, band, lo), p2, TOL_K2,
                    parts=vp),
            compare(f"K2c data (unmasked, {route}) {label}",
                    lambda: fn(lctx, wa_t, phys, scheme, ones, zeros),
                    lambda: lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, ones, zeros),
                    TOL_K2, parts=vp))
    k2 = lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, band, lo)
    t2 = lambda: lat.jacobian_volume_two_pass(lctx, wa_t, phys, scheme, keep16, add16, band, lo)
    data = k2()
    out6 = torch.empty((6, n), dtype=torch.float32)
    b1, ops1 = nbytes(lctx.res_geom, wa_t, dwa_t, out6), op_count(p1)
    b2, ops2 = nbytes(lctx.lhs_geom, wa_t, keep16, add16, band, data), op_count(p2)
    recs = [
        finish(f"{CLASS_KERNELS[0][0]} {label}", {"max_abs_err": e1}, k1, p1, 20, 5, b1, ops1),
        finish(f"{CLASS_KERNELS[1][0]} {label}", {"max_abs_err": errs["one pass"]}, k2, p2, 10, 3,
               b2, ops2),
        finish(f"{CLASS_KERNELS[3][0]} {label}", {"max_abs_err": e1t}, t1, p1, 20, 5, b1, ops1),
        finish(f"{CLASS_KERNELS[4][0]} {label}", {"max_abs_err": errs["two passes"]}, t2, p2, 10,
               3, b2, ops2),
    ]
    turns = {"K1c": in_turns(f"K1c {label}", k1, t1, 20),
             "K2c": in_turns(f"K2c {label}", k2, t2, 10), "k1c_one_equals_two": same}
    return recs, turns


def class_implicit_records(msolver) -> tuple[list, dict]:
    """K2c in its implicit mode at the melt box, on the melt solver's own
    (Kuhn) context: the one-pass kernel and the two-pass entry against
    their plain version per vel/p block and phi/T tangent, timed with K2's
    implicit bound, then in turns."""
    import torch

    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
    from dedflow_tpu_torch.tools.timing import nbytes

    cfg, mesh, lctx = msolver.cfg, msolver.mesh, msolver.lctx
    phys, scheme = cfg.physics, cfg.time
    if lctx.grid is None:
        raise PhaseError("classes melt box: the table did not place on a node grid")
    wg, dwgold, dwg = perturbed_melt_state(mesh, cfg, "cuda", msolver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    wa_t = wa.T.contiguous()
    n, nd = lctx.num_node, len(lctx.offsets)
    keep, add = keep_pc_rows(msolver.mask_t, msolver.dtype), diag_add_rows(msolver.mask_t,
                                                                           msolver.dtype)
    band, lo = lat._masked_face_band(msolver.face_ctxs, wa, dwa, phys, scheme, nd, keep)
    pack = lambda d, sc: torch.cat([d.reshape(nd * 16, n), sc])
    parts = {f" data [{b}]": (lambda t, c=list(cs): t[: nd * 16].reshape(nd, 16, n)[:, c])
             for b, cs in VP_BLOCKS.items()}
    parts[" scal [phi-phi]"] = lambda t: t[nd * 16 :: 2]
    parts[" scal [T-T]"] = lambda t: t[nd * 16 + 1 :: 2]
    k2 = lambda: pack(*lat.jacobian_volume_classes(lctx, wa_t, phys, scheme, keep, add, band, lo))
    t2 = lambda: pack(*lat.jacobian_volume_two_pass(lctx, wa_t, phys, scheme, keep, add, band,
                                                    lo))
    p2 = lambda: pack(*lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep, add, band, lo))
    e2 = compare("K2c implicit (masked, one pass), melt box", k2, p2, TOL_K2, parts=parts)
    e2t = compare("K2c implicit (masked, two passes), melt box", t2, p2, TOL_K2, parts=parts)
    data, scal = lat.jacobian_volume_classes(lctx, wa_t, phys, scheme, keep, add, band, lo)
    b2 = nbytes(lctx.lhs_geom, lctx.res_geom[:, 13:19], wa_t[:3], keep, add, band, data, scal)
    ops2 = op_count(p2)
    recs = [finish(CLASS_KERNELS[2][0], {"max_abs_err": e2}, k2, p2, 10, 3, b2, ops2),
            finish(CLASS_KERNELS[5][0], {"max_abs_err": e2t}, t2, p2, 10, 3, b2, ops2)]
    return recs, in_turns("K2c implicit, melt box", k2, t2, 10)


def k3_wide_records(n: int, sy: int, sz: int) -> list:
    """K3 on a synthetic DIA matrix of 27 planes (every corner difference
    of the lattice cell, sy / sz the node strides) at n rows,
    float32 (TOL_K3) and float64 (TOL_F64) against its plain version,
    timed with its bound and a CSR product of the same matrix."""
    import torch

    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec, dia_matvec_plain
    from dedflow_tpu_torch.tools.timing import FP64_OPS_PER_S, nbytes

    offs = tuple(sorted(dx + sy * dy + sz * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    recs = []
    for dtype, tol in ((torch.float32, TOL_K3), (torch.float64, TOL_F64)):
        data = torch.randn((len(offs), 16, n), generator=gen, device="cuda", dtype=dtype)
        scal = torch.randn((2 * len(offs), n), generator=gen, device="cuda", dtype=dtype)
        x = torch.randn((6, n), generator=gen, device="cuda", dtype=dtype)
        kern = lambda: dia_matvec(data, scal, x, offs)
        plain = lambda: dia_matvec_plain(data, scal, x, offs)
        label = f"K3 A x, {len(offs)} planes, {str(dtype).split('.')[1]}"
        err = compare(label, kern, plain, tol, parts=reduce_parts()[0])
        pieces = []
        for k, o in enumerate(offs):
            r = torch.arange(max(0, -o), min(n, n - o), device="cuda")
            by_comp = {c: data[k, c, r] for c in range(16)}
            by_comp.update({16: scal[2 * k, r], 17: scal[2 * k + 1, r]})
            pieces.append((r, r + o, by_comp))
        csr = block_csr(n, pieces)
        xflat = x.reshape(-1)
        recs.append(finish(label, {"max_abs_err": err}, kern, plain, 50, 5,
                           nbytes(data, scal, x, x), op_count(plain),
                           library=(lambda: csr @ xflat, kern()),
                           ops_per_s=FP64_OPS_PER_S if dtype == torch.float64 else None))
        del csr, pieces, data, scal
    return recs


def class_main(solver, label: str) -> dict:
    """One adaptive step of the reference scenario on `solver` from the
    reference initial state: the launch counts of the one-pass K1c, K2c
    and K3 set to 0 just before and read just after (each must be
    positive), and those of the fused K1 / K2 and of the two-pass K1c /
    K2c, which must stay 0; its peak memory."""
    import torch

    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    counters = (lat.residual_volume_classes, lat.jacobian_volume_classes, dia_matvec)
    absent = (lat.residual_volume, lat.jacobian_volume, lat.residual_volume_two_pass,
              lat.jacobian_volume_two_pass)
    for c in absent:
        c.launches = 0
    rec = krylov_step(solver, counters, f"main {label}")
    off = [c.launches for c in absent]
    say(f"  main {label}: fused K1 / K2, two-pass K1c / K2c launches {off} (must be 0); "
        f"fastpath {solver.fastpath}")
    if any(off):
        raise PhaseError(f"classes main {label}: an entry off the path ran: {off}")
    rec["two_pass_launches"] = off[2:]
    torch.cuda.empty_cache()
    return rec


def overlaid_mesh(nx: int, ny: int, nz: int, extra: int = 2):
    """A kernel stress input, not a mesh a user runs: box_mesh(nx, ny, nz)
    with `extra` more tets in every cell, the first of the Kuhn split
    mirrored in x. They overlap the Kuhn tets (the mesh is not conforming),
    but its tables are the classes tier's widest: 6 + extra classes and,
    for extra = 2, 21 DIA planes (a conforming split of a translation-
    regular mesh has at most 15)."""
    import numpy as np

    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.mesh.mesh import Mesh

    box = box_mesh(nx, ny, nz)
    kuhn = box_mesh(1, 1, 1).ien  # node id = corner id ix + 2*iy + 4*iz
    sy, sz = nx + 1, (nx + 1) * (ny + 1)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    base = (ix + sy * iy + sz * iz).ravel()
    corner = np.array([(c & 1) + sy * ((c >> 1) & 1) + sz * ((c >> 2) & 1) for c in range(8)])
    mirrored = (kuhn ^ 1)[:extra][:, [1, 0, 2, 3]]
    ien = np.concatenate([box.ien, (base[:, None, None] + corner[mirrored][None]).reshape(-1, 4)])
    return Mesh(xg=box.xg, ien=ien.astype(box.ien.dtype), boundaries=box.boundaries)


def slice_inputs(mesh, cfg, device, dtype) -> tuple:
    """A slice's perturbed state and, for the melt pool, its source."""
    if cfg.implicit_scalars:
        return (perturbed_melt_state(mesh, cfg, device, dtype),
                melt_source(mesh, cfg, 1, device, dtype))
    return perturbed_state(mesh, device, dtype), None


def krylov_witness(label: str, mesh, cfg, card: list, ref: list, inputs=None) -> tuple:
    """The card's Krylov counts `card` against the CPU float64 step's `ref`,
    a list each per Newton iteration: plain float32 steps on the CPU (no
    kernels), on the slice's input and on copies perturbed by SLICE_F32_EPS
    relative (seeded), until every count of the card's lies between the
    float64 count and the float32 ones of its Newton iteration. `inputs`
    (mesh, cfg, device, dtype) -> (state, source) makes the input
    (slice_inputs by default). Returns (the plain float32 counts on the
    slice's own input, the steps taken); raises after SLICE_F32_RUNS steps."""
    import torch

    from dedflow_tpu_torch.solver.newton import NSSolver

    solver = NSSolver(mesh, cfg, device="cpu", dtype=torch.float32)
    lo, hi, own = list(ref), list(ref), None
    for k in range(SLICE_F32_RUNS):
        state, src = (inputs or slice_inputs)(mesh, cfg, "cpu", torch.float32)
        if k:
            gen = torch.Generator().manual_seed(SEED + k)
            state = tuple(t * (1 + SLICE_F32_EPS * torch.randn(t.shape, generator=gen,
                                                               dtype=t.dtype)) for t in state)
        kry = solver.step(*state, source=src)[-1].krylov_iters
        own = own or kry
        for i, c in enumerate(kry[: len(lo)]):
            lo[i], hi[i] = min(lo[i], c), max(hi[i], c)
        if all(l <= c <= h for c, l, h in zip(card, lo, hi)):
            return own, k + 1
    raise PhaseError(f"classes slice {label}: the card's Krylov counts {card} leave the float32 "
                     f"range {list(zip(lo, hi))} of {SLICE_F32_RUNS} plain steps")


def class_slices() -> dict:
    """Box 12, card float32 against CPU float64, one adaptive step each from
    a perturbed state: states within TOL_SLICE, equal Newton counts, Krylov
    counts equal or witnessed by plain float32 steps (krylov_witness). (a)
    the deformed box (classes), (b) the shuffled, mirrored and recovered box
    (lattice, another split), (c) the L-shaped part of the box (classes,
    dead lanes), (d) the melt pool with its source on (a) (K2c implicit),
    (e) pc "mg" on (a) (the grid inferred from the class stencil), and a
    kernel check, (f) overlaid_mesh (8 classes, 21 DIA planes, in GMRES's
    products). The launch counts of K1c, K2c, K2c's implicit mode and K3
    (the one-pass kernels: every slice's table places on a node grid) and
    of the two-pass entries (which must stay 0) are set to 0 just before
    each slice's card step and read just after.
    Returns each slice's worst relative error, Krylov counts and
    launches."""
    import torch

    from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config, reference_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.mesh.gen import box_mesh, deformed_mesh, l_shaped_mesh, shuffled_mesh
    from dedflow_tpu_torch.mesh.recover import recover_lattice
    from dedflow_tpu_torch.solver.newton import NSSolver
    from dedflow_tpu_torch.sparse.dia_kernels import dia_matvec

    box = box_mesh(*SLICE_BOX)
    deformed = deformed_mesh(box)
    recovered = recover_lattice(shuffled_mesh(box, seed=SEED + 1, mirror=True))[0]
    ref = reference_scenario_config()
    cases = {
        "(a) deformed": (deformed, ref, "classes"),
        "(b) recovered, mirrored": (recovered, ref, "lattice"),
        "(c) L-shaped": (l_shaped_mesh(*SLICE_BOX), l_shaped_config(), "classes"),
        "(d) melt on (a)": (deformed, melt_pool_scenario_config(), "classes"),
        "(e) pc mg on (a)": (deformed, with_krylov(ref, pc="mg"), "classes"),
        "(f) kernel check, 8 classes, 21 planes": (overlaid_mesh(*SLICE_BOX), ref, "classes"),
    }
    names = ("K1c", "K2c", "K2c implicit", "K3", "K1c two passes", "K2c two passes",
             "K2c two passes implicit")
    out = {}
    for label, (mesh, cfg, tier) in cases.items():
        runs = []
        for device in ("cuda", "cpu"):
            solver = NSSolver(mesh, cfg, device=device)
            if solver.fastpath != tier or solver.lctx.fused is not None or solver.lctx.grid is None:
                raise PhaseError(f"classes slice {label}: fastpath {solver.fastpath!r}")
            if label.startswith("(f)") and (len(solver.lctx.deltas), len(solver.lctx.offsets)) != (
                    8, 21):
                raise PhaseError(f"classes slice {label}: {len(solver.lctx.deltas)} classes, "
                                 f"{len(solver.lctx.offsets)} planes")
            state, src = slice_inputs(mesh, cfg, device, solver.dtype)
            for c in (lat.residual_volume_classes, lat.jacobian_volume_classes, dia_matvec,
                      lat.residual_volume_two_pass, lat.jacobian_volume_two_pass):
                c.launches = 0
            lat.jacobian_volume_classes.implicit_launches = 0
            lat.jacobian_volume_two_pass.implicit_launches = 0
            *got, stats = solver.step(*state, source=src)
            launches = [lat.residual_volume_classes.launches, lat.jacobian_volume_classes.launches,
                        lat.jacobian_volume_classes.implicit_launches, dia_matvec.launches,
                        lat.residual_volume_two_pass.launches,
                        lat.jacobian_volume_two_pass.launches,
                        lat.jacobian_volume_two_pass.implicit_launches]
            runs.append(([t.cpu() for t in got], len(stats.rnorms), stats.krylov_iters, launches))
        (g_states, g_newton, g_kry, g_launches), (r_states, r_newton, r_kry, _) = runs
        worst = 0.0
        for g, r in zip(g_states, r_states):
            if not bool(torch.isfinite(g).all()):
                raise PhaseError(f"classes slice {label}: non-finite state on the card")
            worst = max(worst, rel_err(g, r)[1])
        say(f"  slice {label}: card f32 vs cpu f64 rel={worst:.3e} (tol {TOL_SLICE:.0e}); newton "
            f"{g_newton} / {r_newton}, krylov {g_kry} / {r_kry}; launches "
            f"{dict(zip(names, g_launches))}")
        check(f"classes slice {label}", worst, TOL_SLICE)
        if g_newton != r_newton:
            raise PhaseError(f"classes slice {label}: the card's Newton count differs")
        rec = {"rel": worst, "krylov_card": g_kry, "krylov_f64": r_kry,
               "launches": dict(zip(names, g_launches))}
        if g_kry != r_kry:
            rec["krylov_f32_plain"], rec["f32_steps"] = krylov_witness(label, mesh, cfg, g_kry,
                                                                       r_kry)
            say(f"  slice {label}: krylov card {g_kry}, cpu f64 {r_kry}, cpu f32 plain "
                f"{rec['krylov_f32_plain']}; the card's counts within the float32 range after "
                f"{rec['f32_steps']} plain steps (inputs {SLICE_F32_EPS:.0e} apart)")
        if min(g_launches[:2]) <= 0 or (cfg.implicit_scalars and g_launches[2] <= 0):
            raise PhaseError(f"classes slice {label}: K1c / K2c did not run: {g_launches}")
        if any(g_launches[4:]):
            raise PhaseError(f"classes slice {label}: the two-pass K1c / K2c ran: {g_launches}")
        out[label] = rec
    if out["(f) kernel check, 8 classes, 21 planes"]["launches"]["K3"] <= 0:
        raise PhaseError("classes slice (f): K3 did not run on 21 planes")
    return out


def p1_prime(msolver) -> dict:
    """The Kuhn contexts' own table through the one-pass K1c / K2c, in turns
    with the compile-time K1 / K2 (fused, classes, classes, fused): box 55
    reference (K2 frozen, masked with the band) and the melt box with its
    source (K2 implicit). K1c must equal the ticketed K1 bit for bit (both
    add the plain order's contributions from +0.0f), K2c K2 within
    TOL_K2."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver
    from dedflow_tpu_torch.sparse.fsbsr import diag_add_rows, keep_pc_rows
    from dedflow_tpu_torch.tools.timing import time_ms

    def turns(label, fused, classes, reps):
        f1 = time_ms(fused, reps)
        c1, c2 = time_ms(classes, reps), time_ms(classes, reps)
        f2 = time_ms(fused, reps)
        say(f"  {label}: compile-time table {f1:.4f}, {f2:.4f} ms; run-time table {c1:.4f}, "
            f"{c2:.4f} ms (in turns)")
        return {"fused_ms": [f1, f2], "classes_ms": [c1, c2]}

    out = {}
    box = NSSolver(box_mesh(*FULL_BOX), reference_scenario_config(), device="cuda")
    for label, solver, melt in (("box 55", box, False), ("melt box 44 + source", msolver, True)):
        cfg, lctx = solver.cfg, solver.lctx
        if lctx.grid is None or lctx.fused is None:
            raise PhaseError(f"P1' {label}: a Kuhn context without its tables")
        state = (perturbed_melt_state(solver.mesh, cfg, "cuda", solver.dtype) if melt
                 else perturbed_state(solver.mesh, "cuda", solver.dtype))
        wa, dwa = alpha_states(*state, cfg.time)
        src = melt_source(solver.mesh, cfg, 1, "cuda", solver.dtype) if melt else None
        wa_t = wa.T.contiguous()
        args = (lctx, wa_t, dwa.T.contiguous(), cfg.physics, cfg.time, src)
        fused = lambda: lat.residual_volume(*args)
        classes = lambda: lat.residual_volume_classes(*args)
        same = torch.equal(classes(), fused())
        say(f"  P1' {label}: one-pass K1c == the ticketed K1 bit for bit: {same}")
        if not same:
            raise PhaseError(f"P1' {label}: K1c on the Kuhn table differs from the ticketed K1")
        rec = {"K1": turns(f"P1' K1 {label}", fused, classes, 20), "k1c_bit_equal": same}
        nd = len(lctx.offsets)
        keep, add = keep_pc_rows(solver.mask_t, solver.dtype), diag_add_rows(solver.mask_t,
                                                                             solver.dtype)
        band, lo = lat._masked_face_band(solver.face_ctxs, wa, dwa, cfg.physics, cfg.time, nd,
                                         keep)
        if not melt:
            keep, add = keep[:16].contiguous(), add[:16].contiguous()
        jargs = (lctx, wa_t, cfg.physics, cfg.time, keep, add, band, lo)
        flat = lambda r: torch.cat([t.reshape(-1) for t in r]) if melt else r
        k2 = lambda: flat(lat.jacobian_volume(*jargs))
        k2c = lambda: flat(lat.jacobian_volume_classes(*jargs))
        _, rel = rel_err(k2c(), k2())
        check(f"P1' K2c vs K2, {label}", rel, TOL_K2)
        rec["K2"] = turns(f"P1' K2 {label}", k2, k2c, 10)
        rec["k2c_rel"] = rel
        out[label] = rec
    del box
    torch.cuda.empty_cache()
    return out


def phase_classes() -> tuple[list, dict]:
    """Phase 20: box 55 as (a) the deformed box without metadata (the
    classes tier) and (b) a shuffled, mirrored copy recovered by
    recover_lattice (the lattice tier with another split): the one-pass
    K1c and K2c (each table placed on its node grid) and the two-pass
    entries against their plain versions with times and bounds, the two
    routes in turns, then one adaptive step of each (main path: launches,
    peak memory); K3 on a synthetic 27-plane matrix; K2c implicit (both
    routes) and P1' at the melt box; the box-12 slices. Returns the kernel
    records (CLASS_KERNELS' order, with their launches) and the summary."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh, deformed_mesh, shuffled_mesh
    from dedflow_tpu_torch.mesh.recover import recover_lattice
    from dedflow_tpu_torch.utils import nvcc

    summary = {}
    ref = reference_scenario_config()
    box = box_mesh(*FULL_BOX)
    deformed = deformed_mesh(box)
    asolver, asetup = class_solver(deformed, ref, "classes", "(a)")
    say(f"  (a) deformed box {FULL_BOX}: {deformed.num_tet} tets, {len(asolver.lctx.deltas)} "
        f"classes, {len(asolver.lctx.offsets)} planes, solver set-up {asetup:.2f} s; node grid "
        f"{asolver.lctx.grid}")
    a_recs, summary["(a) turns"] = class_kernel_records(asolver, "(a)")
    summary["(a) main"] = class_main(asolver, "(a) classes")
    summary["(a) main"]["setup_s"] = asetup
    del asolver
    t0 = time.perf_counter()
    shuffled = shuffled_mesh(box, seed=SEED + 1, mirror=True)
    shuffle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recovered, _ = recover_lattice(shuffled)
    recover_s = time.perf_counter() - t0
    bsolver, bsetup = class_solver(recovered, ref, "lattice", "(b)")
    say(f"  (b) shuffled, mirrored box {FULL_BOX}: shuffle {shuffle_s:.2f} s, recover_lattice "
        f"{recover_s:.2f} s (lattice {recovered.lattice}, tets a cell "
        f"{[list(map(int, t)) for t in recovered.lattice_tets]}), solver set-up {bsetup:.2f} s; "
        f"node grid {bsolver.lctx.grid}")
    b_recs, summary["(b) turns"] = class_kernel_records(bsolver, "(b)")
    summary["(b) main"] = class_main(bsolver, "(b) recovered lattice")
    summary["(b) main"].update(setup_s=bsetup, recover_s=recover_s)
    del bsolver, shuffled, recovered
    torch.cuda.empty_cache()
    libs = nvcc.load(["lattice_classes", "lattice_residual", "lattice_jacobian"])
    two, res, jac = libs["lattice_classes"], libs["lattice_residual"], libs["lattice_jacobian"]
    ptxas = {
        "K1c one pass": ptxas_of(res, "residual_fused_kernel", "GridCells"),
        "K2c one pass frozen": ptxas_of(jac, "jacobian_fused_kernelILb0E", "GridPlanes"),
        "K2c one pass implicit": ptxas_of(jac, "jacobian_fused_kernelILb1E", "GridPlanes"),
        "K1 (Kuhn)": ptxas_of(res, "residual_fused_kernel", "KuhnCells"),
        "K2 frozen (Kuhn)": ptxas_of(jac, "jacobian_fused_kernelILb0E", "KuhnPlanes"),
        "K2 implicit (Kuhn)": ptxas_of(jac, "jacobian_fused_kernelILb1E", "KuhnPlanes"),
        "K1c two passes: element / node": [ptxas_of(two, "residual_classes_element_kernel"),
                                           ptxas_of(two, "residual_classes_node_kernel")],
        "K2c two passes: element frozen / implicit, plane 16 / 18": [
            ptxas_of(two, "jacobian_classes_element_kernelILb0E"),
            ptxas_of(two, "jacobian_classes_element_kernelILb1E"),
            ptxas_of(two, "jacobian_classes_plane_kernelILi16E"),
            ptxas_of(two, "jacobian_classes_plane_kernelILi18E")],
    }
    summary["ptxas"] = ptxas
    say(f"  ptxas (registers, spill bytes): {json.dumps(ptxas)}")
    k3 = k3_wide_records(box.num_node, FULL_BOX[0] + 1, (FULL_BOX[0] + 1) * (FULL_BOX[1] + 1))
    msolver, msetup = melt_solver()
    summary["P1'"] = p1_prime(msolver)
    implicit, summary["implicit turns"] = class_implicit_records(msolver)
    del msolver
    torch.cuda.empty_cache()
    summary["slices"] = class_slices()
    mains = (summary["(a) main"], summary["(b) main"])
    launches = [sum(m["launches"][i] for m in mains) for i in range(2)]
    two_pass = [sum(m["two_pass_launches"][i] for m in mains) for i in range(2)]
    summary["b_kernels"] = b_recs
    # no main path runs K2c's implicit mode or K3 past 15 planes: their
    # launches are those of the slices that do, (d) and (f), each alone
    slices = summary["slices"]
    d_launches = slices["(d) melt on (a)"]["launches"]
    return [a_recs[0] | {"launches": launches[0]}, a_recs[1] | {"launches": launches[1]},
            implicit[0] | {"launches": d_launches["K2c implicit"],
                           "launches_of": "box-12 slice (d)"},
            a_recs[2] | {"launches": two_pass[0]}, a_recs[3] | {"launches": two_pass[1]},
            implicit[1] | {"launches": d_launches["K2c two passes implicit"],
                           "launches_of": "box-12 slice (d)"},
            k3[0] | {"launches": slices["(f) kernel check, 8 classes, 21 planes"]["launches"]["K3"],
                     "launches_of": "box-12 slice (f)"}], summary



# ---------------------------------------------------------------------------
# phase 21: the CLI's run outputs (ROADMAP A17b: solution snapshots, restarts,
# JSONL metrics, profiler traces, particle files)

# The JAX CLI's metrics record (dedflow_tpu/app/main.py:355-368) and the
# writer's wall_s (dedflow_tpu/utils/log.py:37).
JAX_METRICS_KEYS = {"step", "t", "step_wall_s", "newton_iters", "converged", "rnorm",
                    "krylov_iters", "linear_rel", "wall_s"}
# The CUDA kernels of K1-K3 as a profiler trace names them.
TRACE_KERNELS = {"K1": "residual_fused_kernel", "K2": "jacobian_fused_kernel",
                 "K3": "dia_spmv_kernel"}
RUN_PARTICLES = 200  # the coupled CLI run at SLICE_BOX


class MemoryFiles:
    """The CLI's solution and particle file calls on a dict, keyed by path:
    the datasets of io.h5.solution_datasets and of
    dem.particles.particle_datasets (a group each). The card machine has no
    h5py; the same layout goes through the same CLI code."""

    def __init__(self):
        self.store = {}

    def write_solution(self, path, wg, dwg, step=None, time=None):
        from dedflow_tpu_torch.io.h5 import solution_datasets

        self.store[path] = solution_datasets(wg, dwg, step, time)

    def read_solution(self, path):
        from dedflow_tpu_torch.io.h5 import state_from_datasets

        return state_from_datasets(self.store[path])

    def save_particles(self, path, group, state):
        from dedflow_tpu_torch.dem.particles import particle_datasets

        self.store.setdefault(path, {})[group] = particle_datasets(state)

    def datasets(self, path, group=None) -> dict:
        return self.store[path] if group is None else self.store[path][group]


class H5Datasets:
    """Reads back the datasets of the CLI's real HDF5 files (where h5py
    imports)."""

    def datasets(self, path, group=None) -> dict:
        import h5py
        import numpy as np

        out = {}
        with h5py.File(path, "r") as f:
            g = f if group is None else f[group]
            g.visititems(lambda name, obj: out.__setitem__(name, np.asarray(obj[()]))
                         if isinstance(obj, h5py.Dataset) else None)
        return out


def run_files():
    """(the CLI's RunFiles, a reader of what they stored, which one): real
    HDF5 files where h5py imports, the in-memory store otherwise."""
    from dedflow_tpu_torch.app.main import RunFiles

    try:
        import h5py  # noqa: F401
    except ImportError:
        mem = MemoryFiles()
        return (RunFiles(write_solution=mem.write_solution, read_solution=mem.read_solution,
                         save_particles=mem.save_particles, needs_h5py=False), mem,
                "in-memory datasets (no h5py on this machine)")
    return RunFiles(), H5Datasets(), "HDF5 files (h5py)"


def same_datasets(label: str, got: dict, ref: dict) -> None:
    """Dataset names, dtypes and values equal bit for bit."""
    import numpy as np

    bad = sorted(set(got) ^ set(ref)) + [
        k for k in set(got) & set(ref)
        if got[k].dtype != ref[k].dtype or not np.array_equal(got[k], ref[k])]
    say(f"  {label}: bit for bit {not bad}" + (f" (differ: {bad})" if bad else ""))
    if bad:
        raise PhaseError(f"{label}: datasets differ: {bad}")


def cli(argv, files) -> tuple[int, list]:
    """app.main.main on `argv`: (exit code, its stdout JSON lines), the lines
    kept off this script's stdout."""
    import contextlib
    import io

    from dedflow_tpu_torch.app import main as app_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = app_main.main(argv, files=files)
    return rc, [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def phase_run(main_out: dict) -> dict:
    """Phase 21: the CLI at box 55 (reference scenario, two steps, a
    snapshot each, metrics, a profiler trace): its step-2 snapshot equal
    bit for bit to phase 5's state after the same two steps, the metrics
    records with the JAX CLI's keys, the trace naming K1-K3's kernels;
    `--resume 1 --steps 1` equal bit for bit to NSSolver.step from the
    snapshot's reconstruction (dwgold = dwg); the coupled scenario at box
    12 with RUN_PARTICLES particles storing particles.1, equal to a direct
    CoupledSolver step. Prints the snapshot's host cost and the steps'
    walls with the trace on against phase 5's without it."""
    import glob
    import os
    import shutil
    import tempfile

    import torch

    from dedflow_tpu_torch.app.coupled import CoupledSolver
    from dedflow_tpu_torch.app.scenarios import (
        coupled_scenario_setup,
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.dem.particles import particle_datasets, particles_from_datasets
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.io.h5 import solution_datasets, state_from_datasets
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver

    files, stored, how = run_files()
    say(f"  solution files: {how}")
    dt = reference_scenario_config().time.dt
    box = [str(n) for n in FULL_BOX]
    root = tempfile.mkdtemp(prefix="dedflow_run_")
    summary = {"files": how}
    try:
        out, prof = os.path.join(root, "out"), os.path.join(root, "profile")
        metrics = os.path.join(root, "metrics.jsonl")
        t0 = time.perf_counter()
        rc, lines = cli(["--box", *box, "--steps", "2", "--save-every", "1", "--metrics", metrics,
                         "--profile", prof, "--out", out], files)
        run_s = time.perf_counter() - t0
        if rc != 0:
            raise PhaseError(f"run: the CLI exited with {rc}")
        recs = [json.loads(ln) for ln in open(metrics).read().splitlines()]
        keys = [sorted(r) for r in recs]
        say(f"  run: {run_s:.1f} s with set-up and trace; metrics records {len(recs)}, keys "
            f"{keys[0] if keys else None}")
        if len(recs) != 2 or any(set(r) != JAX_METRICS_KEYS for r in recs):
            raise PhaseError(f"run: metrics records {keys}, not two with the JAX CLI's keys")
        wg, _, dwg = main_out["state"]
        same_datasets("sol.2 == phase 5's state after two steps",
                      stored.datasets(os.path.join(out, "sol.2.h5")),
                      solution_datasets(wg, dwg, 2, 2 * dt))
        traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
        if len(traces) != 1:
            raise PhaseError(f"run: {len(traces)} profiler trace files, not one")
        text = open(traces[0]).read()
        named = {k: text.count(name) for k, name in TRACE_KERNELS.items()}
        trace_mb = os.path.getsize(traces[0]) / 1e6
        say(f"  profiler trace {trace_mb:.1f} MB, occurrences of {TRACE_KERNELS}: {named}")
        if min(named.values()) == 0:
            raise PhaseError(f"run: the trace does not name every kernel of K1-K3: {named}")
        del text
        walls = [ln["wall_s"] for ln in lines]
        summary.update(trace_mb=trace_mb, step_s_profiled=walls, step_s_plain=main_out["step_s"])
        say(f"  steps with --profile: {walls} s; the same two steps without it (phase 5): "
            f"{main_out['step_s']} s")
        # the snapshot's host work at this size: the copies off the card and the layout
        wg_c, dwg_c = (t.cuda() for t in (wg, dwg))
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            files.write_solution(os.path.join(root, "timed.h5"), wg_c.cpu().numpy(),
                                 dwg_c.cpu().numpy(), step=2, time=2 * dt)
            host.append((time.perf_counter() - t0) * 1e3)
        summary["snapshot_ms"] = sorted(host)[2]
        say(f"  snapshot host cost at box {FULL_BOX} ({wg.shape[0]} nodes): median "
            f"{summary['snapshot_ms']:.2f} ms of {[round(h, 2) for h in host]}")
        rc, lines = cli(["--box", *box, "--steps", "1", "--resume", "1", "--save-every", "1",
                         "--metrics", os.path.join(root, "resume.jsonl"), "--out", out], files)
        if rc != 0 or [ln["step"] for ln in lines] != [2]:
            raise PhaseError(f"run: --resume 1 exited with {rc}, steps {lines}")
        snap = state_from_datasets(stored.datasets(os.path.join(out, "sol.1.h5")))
        solver = NSSolver(box_mesh(*FULL_BOX), reference_scenario_config(), device="cuda")
        rwg, _, rdwg, stats = solver.step(*state_from_numpy(snap["wg"], snap["dwg"], snap["dwg"],
                                                            "cuda", solver.dtype))
        same_datasets("--resume 1 sol.2 == NSSolver.step from sol.1 with dwgold = dwg",
                      stored.datasets(os.path.join(out, "sol.2.h5")),
                      solution_datasets(rwg, rdwg, 2, 2 * dt))
        summary["resume_step_s"] = lines[0]["wall_s"]
        del solver
        torch.cuda.empty_cache()
        cout = os.path.join(root, "coupled")
        rc, lines = cli(["--scenario", "coupled", "--box", *map(str, SLICE_BOX), "--particles",
                         str(RUN_PARTICLES), "--steps", "1", "--save-every", "1", "--out", cout],
                        files)
        if rc != 0:
            raise PhaseError(f"run: the coupled CLI exited with {rc}")
        mesh = box_mesh(*SLICE_BOX)
        ccfg, pst = coupled_scenario_setup(mesh, num_particles=RUN_PARTICLES, device="cuda")
        csolver = CoupledSolver(mesh, reference_scenario_config(), ccfg, device="cuda")
        *_, pst1, _ = csolver.step(*state_from_numpy(*reference_initial_state(mesh), "cuda",
                                                     csolver.dtype), pst)
        ptc = stored.datasets(os.path.join(cout, "particles.1.h5"), "ptc")
        loaded = particles_from_datasets(ptc, device="cuda", dtype=csolver.dtype)
        same_datasets(f"particles.1 ({loaded.num_particle} particles) == a direct "
                      f"CoupledSolver step", particle_datasets(loaded), particle_datasets(pst1))
        same_datasets("particles.1 rebuilt and stored again", particle_datasets(loaded), ptc)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return summary


# ---------------------------------------------------------------------------
# phase 22: the scalar heat / Poisson slice (ROADMAP A12, BASELINE config #1):
# K8 and K9 with one output row

HEAT_BOXES = ((15, 15, 15), FULL_BOX)  # BASELINE config #1's ~20k tets (20,250); 998,250 tets
HEAT_SLICE_BOX = SLICE_BOX
HEAT_RTOL = 1e-6  # float32 CG / GMRES stop
HEAT_CG_MAXIT, HEAT_GMRES_RESTART, HEAT_GMRES_MAXIT = 2000, 120, 4800
# The box-12 slice: a float32 CG stopped at rtol 1e-6 against a float64
# one at 1e-10; the discrete solution is smooth and O(1), so the two agree
# to the float32 solve's accuracy, well inside the other slices' bar.
TOL_HEAT_SLICE = 1e-4
HEAT_KERNELS = (
    ("K8 stream reduce (heat, one row)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
    ("K9 ring reduce (heat, one row)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
)


def poisson_system(mesh, device, dtype):
    """The steady Poisson problem of the JAX package's tests/test_heat.py:
    -lap(u) = 3 pi^2 sin(pi x) sin(pi y) sin(pi z), u = 0 on all six faces
    (exact solution the sine product). Returns (solve-ready (K, b), the
    exact nodal solution, assemble: a function that assembles K and b
    again, the context)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.fem.assembly import build_context
    from dedflow_tpu_torch.fem.dirichlet import StrongBC, apply_mat, apply_vec, build_mask
    from dedflow_tpu_torch.fem.heat import assemble_poisson

    ctx = build_context(mesh, device=device, dtype=dtype, scalar_plans=True)
    x, y, z = mesh.xg.T
    exact = np.sin(np.pi * x) * np.sin(np.pi * y) * np.sin(np.pi * z)
    f = torch.as_tensor(3 * np.pi**2 * exact, dtype=dtype, device=device)
    mask = torch.as_tensor(build_mask(mesh, [StrongBC(i, (0,)) for i in range(6)], 1),
                           device=device)

    def assemble():
        k, b = assemble_poisson(ctx, f)
        return apply_mat(mask, k), apply_vec(mask[:, 0], b)

    return assemble(), exact, assemble, ctx


def poisson_solve(system, method: str, rtol: float = HEAT_RTOL):
    """Jacobi-preconditioned CG, or GMRES(120) + Jacobi, on (K, b)."""
    from dedflow_tpu_torch.solver.krylov import cg, gmres
    from dedflow_tpu_torch.solver.pc import JacobiPC

    k, b = system
    pc = JacobiPC.from_diag(k.diag_blocks()[:, 0, 0])
    mv = lambda v: k.matvec(v[:, None])[:, 0]
    if method == "cg":
        return cg(mv, b, maxit=HEAT_CG_MAXIT, atol=0.0, rtol=rtol, pc=pc)
    return gmres(mv, b, maxit=HEAT_GMRES_MAXIT, atol=0.0, rtol=rtol, pc=pc,
                 restart=HEAT_GMRES_RESTART)


def heat_kernel_records(ctx) -> list:
    """K8 and K9 with one output row on the box-55 Poisson plans (seeded
    element values), against their plain versions, timed, with bounds and
    an index_add; each must beat its index_add (the one-pass entry of
    csrc/seg_reduce.cu exists to: index_add's float32 atomics would not
    repeat bit for bit)."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.sparse.win_ring import ring_reduce, ring_reduce_plain
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain

    rng = np.random.default_rng(SEED)
    recs = []
    for (label, _, _), plan, slots, kern, plain, tol in (
            (HEAT_KERNELS[0], ctx.scalar_res_plan, 4, stream_reduce, stream_reduce_plain, TOL_K8),
            (HEAT_KERNELS[1], ctx.scalar_jac_plan, 16, ring_reduce, ring_reduce_plain, TOL_K9)):
        m = slots * ctx.num_elem
        x = torch.as_tensor(rng.standard_normal((1, m)), dtype=torch.float32, device="cuda")
        kcall, pcall = (lambda f=kern, p=plan: f(p, x)), (lambda f=plain, p=plan: f(p, x))
        say(f"  {label}: {plan.src.numel()} contributions into {plan.num_tgt} targets")
        err = compare(label, kcall, pcall, tol)
        rec = finish(label, {"max_abs_err": err}, kcall, pcall, 20, 5,
                     reduce_bytes(plan, (0,), 1), op_count(pcall),
                     library=(index_add_call(plan, x, (0,), m), kcall()))
        if not rec["ms"] < rec["library_ms"]:
            raise PhaseError(f"{label}: {rec['ms']:.4f} ms, not faster than index_add's "
                             f"{rec['library_ms']:.4f} ms")
        recs.append(rec)
    return recs


def peak_bytes(fn) -> int:
    """Device bytes one call allocates at its peak, above what was
    allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_heat() -> tuple[list, dict]:
    """Phase 22: K8 / K9 one-row on the box-55 Poisson plans; the box-12
    slice (card float32 CG against the CPU's float64 solve); then box 15
    and box 55 (the main path, launch counts read around it): assembly ms
    and peak device memory, CG and GMRES(120) iterations, solve s and the
    L2 error against the exact solution, each solve repeated with its
    count."""
    import numpy as np
    import torch

    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce
    from dedflow_tpu_torch.tools.timing import time_ms

    summary = {}
    sols = []
    for device, dtype, rtol in (("cuda", torch.float32, HEAT_RTOL), ("cpu", torch.float64, 1e-10)):
        system, _, _, _ = poisson_system(box_mesh(*HEAT_SLICE_BOX), device, dtype)
        info = poisson_solve(system, "cg", rtol)
        sols.append(info.x.cpu())
        say(f"  slice box {HEAT_SLICE_BOX} {device} {dtype}: CG iters {info.iters}, converged "
            f"{info.converged}")
        if not info.converged:
            raise PhaseError(f"heat slice: CG did not converge on {device}")
    _, rel = rel_err(*sols)
    say(f"  slice: card f32 CG vs cpu f64 rel={rel:.3e} (tol {TOL_HEAT_SLICE:.0e})")
    check("heat slice", rel, TOL_HEAT_SLICE)
    summary["slice_rel"] = rel
    recs, launches = None, None
    for box in HEAT_BOXES:
        mesh = box_mesh(*box)
        t0 = time.perf_counter()
        main_box = box == FULL_BOX
        if main_box:
            for c in (stream_reduce, ring_reduce):
                c.launches = 0
        system, exact, assemble, ctx = poisson_system(mesh, "cuda", torch.float32)
        setup_s = time.perf_counter() - t0
        cell = {"tets": mesh.num_tet, "nodes": mesh.num_node, "setup_s": setup_s}
        for method in ("cg", "gmres"):
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                info = poisson_solve(system, method)
                torch.cuda.synchronize()
                runs.append((info, time.perf_counter() - t0))
            (one, s1), (two, s2) = runs
            err = float(np.sqrt(np.mean((one.x.double().cpu().numpy() - exact) ** 2)))
            same_x = torch.equal(one.x, two.x)
            cell[method] = {"iters": [one.iters, two.iters], "converged": one.converged,
                            "solve_s": [s1, s2], "l2_err": err, "x_bit_equal": same_x,
                            "rel_res": float(one.resnorm / one.resnorm0)}
            say(f"  box {box} ({mesh.num_tet} tets) {method}: iters {one.iters} / {two.iters}, "
                f"converged {one.converged}, relative residual {cell[method]['rel_res']:.3e}, "
                f"solve {s1:.4f} / {s2:.4f} s, L2 error {err:.4e}, x bit-equal {same_x}")
            if one.iters != two.iters:
                raise PhaseError(f"heat box {box} {method}: counts {one.iters} != {two.iters}")
            if not np.isfinite(err):
                raise PhaseError(f"heat box {box} {method}: non-finite solution")
        if main_box:
            launches = [stream_reduce.launches, ring_reduce.launches]
            say(f"  launches K8/K9 one-row over the box-55 assembly and solves: {launches}")
            if min(launches) <= 0:
                raise PhaseError(f"heat: a kernel of the path was not launched: {launches}")
        cell["assembly_ms"] = time_ms(assemble, 5)
        cell["assembly_peak_bytes"] = peak_bytes(assemble)
        say(f"  box {box}: set-up {setup_s:.2f} s, assembly (K, b, Dirichlet rows) "
            f"{cell['assembly_ms']:.3f} ms, peak {cell['assembly_peak_bytes'] / 1e6:.1f} MB "
            f"above the context")
        summary[f"box {box[0]}"] = cell
        if main_box:
            recs = heat_kernel_records(ctx)
        del system, ctx
        torch.cuda.empty_cache()
    return [r | {"launches": n, "launches_of": "phase 22 heat: box-55 Poisson assembly + solves"}
            for r, n in zip(recs, launches)], summary


# Mixed prism / hex meshes (ROADMAP A13): a converted mesh's wedge and
# hexahedron tables add stencil entries (their node pairs), and only the tets
# are assembled. A hex table over every cube of the box gives the full
# 27-point stencil, which leaves the lattice's 15: the JAX ladder then takes
# the WinELL tier (box order passes its gate), whose kernels run on 27-wide
# rows. The slice adds a prism boundary layer (two wedges a cube of the
# lowest cell layer).
MIXED_SLICE_PRISM_LAYERS = 1
MIXED_TIER = "winell"
MIXED_TAG = "mixed box-55 pattern"
MIXED_KERNELS = (
    ("K6 element rows (residual, " + MIXED_TAG + ")", "dedflow_tpu_torch/csrc/element_rows.cu",
     "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K6 element rows staged (jacobian, " + MIXED_TAG + ")",
     "dedflow_tpu_torch/csrc/element_rows.cu", "dedflow_tpu/fem/pallas_kernels.py:565"),
    ("K7 winell spmv (" + MIXED_TAG + ", 27-wide rows)", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:55"),
    ("K8 stream reduce (" + MIXED_TAG + ")", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:251"),
    ("K9 segment sum (" + MIXED_TAG + ")", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:356"),
    ("K10 win gather (residual rows, " + MIXED_TAG + ")", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
    ("K10 win gather (jacobian rows, " + MIXED_TAG + ")", "dedflow_tpu_torch/csrc/win_gather.cu",
     "dedflow_tpu/sparse/win_gather.py:179"),
)


def mixed_solver(box, prism_layers: int, device: str = "cuda", cfg=None):
    """NSSolver on mesh.gen.mixed_box_mesh(*box) (a hex over every cube,
    prisms on the lowest `prism_layers` layers), the reference scenario
    unless `cfg`; its host set-up seconds. Fails off MIXED_TIER."""
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import mixed_box_mesh
    from dedflow_tpu_torch.solver.newton import NSSolver, stencil_offsets

    mesh = mixed_box_mesh(*box, prism_layers=prism_layers)
    t0 = time.perf_counter()
    solver = NSSolver(mesh, cfg or reference_scenario_config(), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    planes = len(stencil_offsets(mesh))
    if solver.fastpath != MIXED_TIER or planes != 27:
        raise PhaseError(f"mixed box {box}: fastpath {solver.fastpath!r}, {planes} stencil "
                         f"offsets; expected {MIXED_TIER!r} on 27")
    return solver, setup_s


def phase_mixed_slice() -> dict:
    """Phase 23 (a): the box-12 mixed mesh (every cube a hex, the lowest
    layer's cubes two prisms each): one step_fixed(num_newton=2), card
    float32 against CPU float64, TOL_SLICE."""
    import torch

    outs, summary = [], {}
    for device in ("cuda", "cpu"):
        solver, setup_s = mixed_solver(SLICE_BOX, MIXED_SLICE_PRISM_LAYERS, device)
        mesh = solver.mesh
        summary[f"{device}_setup_s"] = setup_s
        state = perturbed_state(mesh, device, solver.dtype)
        outs.append([t.cpu() for t in solver.step_fixed(*state, num_newton=2)])
    say(f"  slice: {mesh.num_tet} tets, {mesh.num_hex} hexes, {mesh.num_prism} prisms, "
        f"{solver.wctx.win_plan.S} matrix entries (max row {int(max(mesh_row_widths(solver)))} "
        f"node blocks), fastpath {solver.fastpath}")
    worst = 0.0
    for name, g, r in zip(("wgold", "dwgold", "dwg"), *outs):
        if not bool(torch.isfinite(g).all()):
            raise PhaseError(f"mixed slice: non-finite {name} on the card")
        _, rel = rel_err(g, r)
        say(f"  {name}: card f32 vs cpu f64 rel={rel:.3e}")
        worst = max(worst, rel)
    check("mixed slice", worst, TOL_SLICE)
    summary["slice_rel"] = worst
    return summary


def mesh_row_widths(solver):
    """The node blocks of each matrix row of a WinELL solver."""
    import numpy as np

    return np.diff(solver.wctx.win_plan.row_ptr)


def phase_mixed_kernels(solver) -> tuple[list, dict]:
    """Phase 23 (b), the kernels of the WinELL tier on the mixed box-55
    pattern against their plain versions, as phase 6 holds them on the
    Delaunay mesh: K10 (both row maps, bit for bit), K6's residual rows,
    the staged K6 (per block, and bit for bit against the column rows at
    the plan positions), K8 on the residual plan, K9's segment sum on the
    staged rows (bit for bit against K9 with its staging pass over the
    column rows), and K7 on the assembled 27-wide Jacobian; each timed
    with its bound and library call (K6: none); K10's residual instance
    also in other element orders (k10_order_ms). Returns the records in
    MIXED_KERNELS' order (launches to be filled) and the system timings."""
    import torch

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import element_rows as er
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.solver.newton import assemble_system, residual
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec, winell_matvec_plain
    from dedflow_tpu_torch.sparse.win_ring import ring_reduce
    from dedflow_tpu_torch.sparse.win_stream import stream_reduce, stream_reduce_plain
    from dedflow_tpu_torch.sparse.winell import COMP2WIN
    from dedflow_tpu_torch.tools.timing import nbytes, time_ms

    phys, scheme = solver.cfg.physics, solver.cfg.time
    ctx, ne = solver.wctx, solver.wctx.num_elem
    names = [name for name, _, _ in MIXED_KERNELS]
    k10 = k10_checks(solver.mesh, ctx.ien_t, ctx.res_geom, scheme)
    k10_order = k10_order_ms(solver.mesh, ctx.ien_t, ctx.res_geom)
    wg, dwgold, dwg = perturbed_state(solver.mesh, solver.device, solver.dtype)
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    # the Jacobian rows are a view of the context's buffer: kept by a clone
    inp67, inp27 = wa_.residual_inputs(ctx, wa, dwa), wa_.jacobian_inputs(ctx, wa).clone()
    by_eq, entry_blocks = reduce_parts()

    k6r = lambda: ek.res_rows_call(inp67, phys, scheme)
    p6r = lambda: er.res_rows(inp67, **ek.res_args(phys, scheme))
    e6r = compare(names[0], k6r, p6r, TOL_K6)
    plan = ctx.jac_plan
    staged, (stage16, _) = staged_record(
        names[1], plan, lambda: ek.lhs_rows_staged(inp27, phys, scheme, plan),
        lambda: ek.lhs_rows_staged_plain(inp27, phys, scheme, plan),
        lambda: ek.stage_rows(plan, ek.lhs_rows_call(inp27, phys, scheme)),
        False, TOL_K6, nbytes(inp27), 10)
    out24 = k6r()
    k8 = lambda: stream_reduce(ctx.res_plan, out24, range(6), ne)
    p8 = lambda: stream_reduce_plain(ctx.res_plan, out24, range(6), ne)
    e8 = compare(names[3], k8, p8, TOL_K8, parts=by_eq)
    # K9 with its staging pass over the column rows: the bit-for-bit witness
    out288 = ek.lhs_rows_call(inp27, phys, scheme)
    k9col = ring_reduce(plan, out288, wa_.JAC_COMPS, ne)
    del out288
    seg = segment_sum_record(names[4], plan, stage16, k9col, 20)
    del stage16, k9col

    jm, pc = assemble_system(ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    gen = torch.Generator(device=solver.device).manual_seed(SEED)
    x = torch.randn((6, ctx.num_node), generator=gen, device=solver.device, dtype=solver.dtype)
    k7 = lambda: winell_matvec(jm, x)
    p7 = lambda: winell_matvec_plain(jm, x)
    e7 = compare(names[2], k7, p7, TOL_K7, parts=by_eq)
    wp = jm.plan
    csr = block_csr(ctx.num_node, [(wp.grow_t.long(), wp.col_t.long(),
                                    {c: jm.vals[int(COMP2WIN[c])] for c in range(18)})])
    xflat = x.reshape(-1)
    out6 = torch.empty((6, ctx.num_node), dtype=torch.float32)
    r7 = finish(names[2], {"max_abs_err": e7}, k7, p7, 100, 10,
                nbytes(jm.vals, wp.col_t, wp.row_ptr_t, x, out6), op_count(p7),
                library=(lambda: csr @ xflat, k7()))
    del csr
    results = [
        finish(names[0], {"max_abs_err": e6r}, k6r, p6r, 20, 3, nbytes(inp67, out24),
               op_count(p6r)),
        staged, r7,
        finish(names[3], {"max_abs_err": e8}, k8, p8, 50, 5,
               reduce_bytes(ctx.res_plan, range(6), 6), op_count(p8),
               library=(index_add_call(ctx.res_plan, out24, range(6), ne), k8())),
        seg,
    ] + k10_records(k10, names[5:7])
    common = (ctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys, scheme)
    widths = mesh_row_widths(solver)
    times = {"F_ms": time_ms(lambda: residual(*common, solver.cfg.freeze_phi_temperature), 10),
             "J_ms": time_ms(lambda: assemble_system(*common), 5), "SpMV_ms": r7["ms"],
             "matrix_entries": wp.S, "row_blocks_max": int(widths.max()),
             "row_blocks_mean": float(widths.mean()),
             "jacobian_MB": jm.vals.numel() * jm.vals.element_size() / 1e6,
             "k10_order_ms": k10_order}
    return results, times


def phase_mixed() -> tuple[list, dict]:
    """Phase 23: (a) the box-12 mixed slice; (b) the box-55 mixed mesh on
    the WinELL tier: its kernels against their plain versions, then the
    main path (drive_main through phase 8's counters: two steps, then step
    1 repeated bit-identical), with set-up s, s/step, counts, peak memory
    and each kernel's launches."""
    out = {"slice": phase_mixed_slice()}
    solver, setup_s = mixed_solver(FULL_BOX, 0)
    mesh = solver.mesh
    say(f"  main: box {FULL_BOX} + {mesh.num_hex} hexes: {mesh.num_tet} tets, {mesh.num_node} "
        f"nodes, {solver.wctx.win_plan.S} matrix entries, fastpath {solver.fastpath}, host "
        f"set-up {setup_s:.2f} s")
    results, times = phase_mixed_kernels(solver)
    say(f"  mixed system: {json.dumps(times)}")
    main = phase_irregular_main(solver)
    n6r, _, n7, n8, _ = main["launches"]
    n6j, n9 = main["staged"]
    launches = [n6r, n6j, n7, n8, n9, main["k10_launches"]["residual"],
                main["k10_launches"]["jacobian"]]
    out.update(setup_s=setup_s, step_s=main["step_s"], peak_bytes=main["peak_bytes"],
               system=times, launches=dict(zip((n for n, _, _ in MIXED_KERNELS), launches)))
    return [r | {"launches": n, "launches_of": "phase 23 mixed: box-55 + hex main path"}
            for r, n in zip(results, launches)], out


# The check tools (ROADMAP A18; dedflow_tpu_torch/tools): the 1e-10 bar at
# BASELINE's ~20k tets, the lattice kernels' self-check at the JAX tool's
# mesh, and the nonlinear parity at a box that keeps the phase near a minute
# (the tool's own default, the JAX tool's 31, is for manual runs).
CHECK_RESIDUAL_BOX = 15
CHECK_NONLINEAR_BOX = 24
CHECK_NONLINEAR_STEPS = 2


def phase_checks() -> dict:
    """Phase 24: tools.residual_check at n = 15 (both relative residuals
    <= 1e-10, or the phase fails), tools.selfcheck at its default n (K1,
    K2, K2' against their plain versions), tools.nonlinear_f64_check at
    CHECK_NONLINEAR_BOX (the card's float32 steps, "ir" and "state", within
    TOL_SLICE of the CPU float64 step's state, finite norms)."""
    from dedflow_tpu_torch.tools import nonlinear_f64_check, residual_check, selfcheck

    out = {}
    t0 = time.perf_counter()
    res = residual_check.residual_check(CHECK_RESIDUAL_BOX, "cuda")
    say(f"  residual_check ({time.perf_counter() - t0:.1f} s): {json.dumps(res)}")
    if not res["pass"]:
        raise PhaseError("residual_check: a relative residual above 1e-10")
    t0 = time.perf_counter()
    sc = selfcheck.selfcheck(device="cuda")
    say(f"  selfcheck ({time.perf_counter() - t0:.1f} s): {json.dumps(sc)}")
    if not sc["pass"]:
        raise PhaseError("selfcheck: a kernel differs from its plain version")
    t0 = time.perf_counter()
    nl = nonlinear_f64_check.nonlinear_check(CHECK_NONLINEAR_BOX, CHECK_NONLINEAR_STEPS, "cuda")
    say(f"  nonlinear_f64_check at box {CHECK_NONLINEAR_BOX} ({time.perf_counter() - t0:.1f} s): "
        f"{json.dumps(nl)}")
    for run in ("cpu_f64", "device_ir", "device_f32"):
        if not all(math.isfinite(v) for norms in nl[run]["field_norms"] for v in norms):
            raise PhaseError(f"nonlinear_f64_check: non-finite field norms in {run}")
    for run in ("device_ir", "device_f32"):
        check(f"nonlinear_f64_check {run}", nl[run]["rel_state_diff_vs_cpu_f64"], TOL_SLICE)
    out.update(residual=res, selfcheck_pass=sc["pass"], nonlinear_box=CHECK_NONLINEAR_BOX,
               nonlinear_rel={r: nl[r]["rel_state_diff_vs_cpu_f64"]
                              for r in ("device_ir", "device_f32")})
    return out


# The multi-device path (ROADMAP A16, first slice: parallel.sharded's z-slab
# decomposition over torch.distributed). The card machine has one card, so
# the ranks share it through gloo (parallel.launch), every band, carry and
# all-reduce staged through pinned host memory.
SHARDED_SLICE_RANKS = (2, 4)
SHARDED_MAIN_RANKS = 2
SHARDED_CLI_BOX = (4, 3, 6)  # the CLI's run through its ranks: 7 node layers
SHARDED_KERNELS = (
    ("K1 lattice residual (slab, box-55 half)", "dedflow_tpu_torch/csrc/lattice_residual.cu",
     "dedflow_tpu/fem/lattice.py:966"),
    ("K2 lattice jacobian (slab, box-55 half)", "dedflow_tpu_torch/csrc/lattice_jacobian.cu",
     "dedflow_tpu/fem/lattice.py:1169"),
    ("K3 dia spmv banded (slab, box-55 half)", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:169"),
)


def npz_write_solution(path, wg, dwg, step=None, time=None):
    """The CLI's snapshot as an .npz of io.h5.solution_datasets (the card
    machine has no h5py; the ranks of a --devices run write from their own
    process, so the in-memory store of phase 21 cannot serve)."""
    import numpy as np

    from dedflow_tpu_torch.io.h5 import solution_datasets

    np.savez(path + ".npz", **solution_datasets(wg, dwg, step, time))


def sharded_slice_rank(device, box=SLICE_BOX):
    """A rank of phase 25 (a): one adaptive step of the reference scenario
    on the box from chip_smoke's perturbed state; rank 0 returns the
    gathered state and the counts."""
    import torch.distributed as dist

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver

    solver = ShardedNSSolver(box_mesh(*box), reference_scenario_config(), device=device)
    state = [t[solver.own] for t in perturbed_state(solver.mesh, device, solver.dtype)]
    *new, stats = solver.step(*state)
    full = [solver.gather_state(t) for t in new]
    if dist.get_rank() == 0:
        return {"state": full, "newton": len(stats.rnorms), "krylov": stats.krylov_iters}


def _counting(fn, calls: list):
    def wrapped(*a, **k):
        calls[0] += 1
        return fn(*a, **k)
    return wrapped


def sharded_main_rank(device):
    """A rank of phase 25 (b) and (c). (b): ShardedNSSolver at box 55,
    one step from the reference initial state, the launch counts set to
    0 just before and read just after (the plain twins counted too: they
    must not run), per-rank walls, exchange and all-reduce counts, bytes
    and host seconds, peak memory; the gathered state. (c): the rank's
    slab K1, K2 (masked and unmasked) and K3's banded entry (masked and
    unmasked) against their plain twins on the step's last state; rank 0
    times them while rank 1 waits. First, in the same process group, the
    box-12 slice of (a). Rank 0 returns everything."""
    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
    from dedflow_tpu_torch.sparse import dia_kernels as dk
    from dedflow_tpu_torch.tools.timing import nbytes

    rank = dist.get_rank()
    slice_out = sharded_slice_rank(device)
    t0 = time.perf_counter()
    mesh = box_mesh(*FULL_BOX)
    solver = ShardedNSSolver(mesh, reference_scenario_config(), device=device)
    state = [solver.shard_state(a) for a in reference_initial_state(mesh)]
    setup_s = time.perf_counter() - t0
    counters = (lat.residual_volume, lat.jacobian_volume, dk.dia_matvec_banded)
    plains = ((lat, "residual_volume_plain"), (lat, "jacobian_volume_plain"),
              (dk, "dia_matvec_banded_plain"))
    plain_calls = [[0] for _ in plains]
    originals = [getattr(m, n) for m, n in plains]
    for (m, n), f, calls in zip(plains, originals, plain_calls):
        setattr(m, n, _counting(f, calls))
    comm = solver.comm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    comm.stats.reset()
    dist.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    *state, stats = solver.step(*state)
    torch.cuda.synchronize()
    s = comm.stats
    steps = [{"wall_s": time.perf_counter() - t1, "newton": len(stats.rnorms),
              "krylov": stats.krylov_iters, "exchanges": s.exchanges, "sent_bytes": s.sent_bytes,
              "exchange_s": s.exchange_s, "allreduces": s.allreduces,
              "allreduce_s": s.allreduce_s, "stage_s": s.stage_s}]
    launches = [c.launches for c in counters]
    for (m, n), f in zip(plains, originals):
        setattr(m, n, f)
    rec = {"rank": rank, "n_own": solver.sctx.n_own, "setup_s": setup_s, "steps": steps,
           "launches": launches, "plain_calls": [c[0] for c in plain_calls],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    full = [solver.gather_state(t) for t in state]

    # (c) the slab kernels against their plain twins on this rank's inputs
    sctx, cfg = solver.sctx, solver.cfg
    phys, scheme, lctx = cfg.physics, cfg.time, sctx.lctx
    wa, dwa = alpha_states(*state, scheme)
    wa_t, dwa_t, _ = lat.slab_states(sctx, wa, dwa)
    keep_pc, add18, band, lo = lat.slab_jacobian_inputs(sctx, solver.face_ctxs, solver.mask_t,
                                                        wa_t, dwa_t, phys, scheme)
    keep16, add16 = keep_pc[:16].contiguous(), add18[:16].contiguous()
    ones16, zeros16 = torch.ones_like(keep16), torch.zeros_like(add16)
    jm = lat.assemble_jacobian_slab(sctx, solver.face_ctxs, solver.mask_t, wa, dwa, phys, scheme)
    left = sctx.width if comm.left is not None else 0
    m = left + sctx.n_own + (sctx.width if comm.right is not None else 0)
    gen = torch.Generator(device=device).manual_seed(SEED + rank)
    x = torch.randn((6, m), generator=gen, device=device)
    raw = lat.jacobian_volume(lctx, wa_t, phys, scheme, ones16, zeros16)[..., : sctx.n_own]
    raw, no_scal = raw.contiguous(), torch.zeros_like(jm.scal)
    pairs = {
        "K1": (lambda: lat.residual_volume(lctx, wa_t, dwa_t, phys, scheme),
               lambda: lat.residual_volume_plain(lctx, wa_t, dwa_t, phys, scheme), TOL_K1),
        "K2": (lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, keep16, add16, band, lo),
               lambda: lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, keep16, add16, band,
                                                 lo), TOL_K2),
        "K2'": (lambda: lat.jacobian_volume(lctx, wa_t, phys, scheme, ones16, zeros16),
                lambda: lat.jacobian_volume_plain(lctx, wa_t, phys, scheme, ones16, zeros16),
                TOL_K2),
        "K3": (lambda: dk.dia_matvec_banded(jm.data, jm.scal, x, jm.offsets, left),
               lambda: dk.dia_matvec_banded_plain(jm.data, jm.scal, x, jm.offsets, left), TOL_K3),
        "K3'": (lambda: dk.dia_matvec_banded(raw, no_scal, x, jm.offsets, left),
                lambda: dk.dia_matvec_banded_plain(raw, no_scal, x, jm.offsets, left), TOL_K3),
    }
    errs = {k: compare(f"rank {rank} slab {k}", kern, plain, tol)
            for k, (kern, plain, tol) in pairs.items()}
    rows = None
    dist.barrier()
    if rank == 0:  # the other ranks wait: one process on the card while it is timed
        out6 = torch.empty((6, lctx.num_node), dtype=torch.float32)
        offs, n = jm.offsets, sctx.n_own
        pieces = []
        for k, o in enumerate(offs):
            rr = torch.arange(max(0, -o - left), min(n, m - left - o), device=device)
            by_comp = {c: jm.data[k, c, rr] for c in range(16)}
            by_comp.update({16: jm.scal[2 * k, rr], 17: jm.scal[2 * k + 1, rr]})
            pieces.append((rr, rr + left + o, by_comp))
        csr, xflat = block_csr(n, pieces, cols=m), x.reshape(-1)
        (k1, p1, _), (k2, p2, _), (k3, p3, _) = pairs["K1"], pairs["K2"], pairs["K3"]
        rows = [
            finish(SHARDED_KERNELS[0][0], {"max_abs_err": errs["K1"]}, k1, p1, 20, 5,
                   nbytes(lctx.res_geom, wa_t, dwa_t, out6), op_count(p1)),
            finish(SHARDED_KERNELS[1][0], {"max_abs_err": max(errs["K2"], errs["K2'"])}, k2, p2,
                   10, 3, nbytes(lctx.lhs_geom, wa_t, keep16, add16, band, k2()), op_count(p2)),
            finish(SHARDED_KERNELS[2][0], {"max_abs_err": max(errs["K3"], errs["K3'"])}, k3, p3,
                   100, 25, nbytes(jm.data, jm.scal, x, out6[:, :n]), op_count(p3),
                   library=(lambda: csr @ xflat, k3())),
        ]
    dist.barrier()
    recs = [None] * comm.world if rank == 0 else None
    dist.gather_object(rec, recs, dst=0)
    if rank == 0:
        return {"ranks": recs, "state": full, "kernels": rows, "slice": slice_out}


def phase_sharded(main_out: dict, krylov_out: dict) -> tuple[list, dict]:
    """Phase 25: (a) box 12 on 2 and 4 gloo ranks sharing the card, one
    adaptive step each against the CPU float64 one-process step (TOL_SLICE,
    equal Newton counts, Krylov counts equal or witnessed by plain float32
    CPU steps); (b) box 55 on 2 ranks, one step from the reference initial
    state against phase 5's first one-process card step (each field's
    state within TOL_SLICE of its scale, equal Newton counts), with s/step, its
    split, per-rank launches (each kernel > 0, plain twins never called),
    peak memory, halo bytes a Newton iteration and all-reduces a Krylov
    iteration; (c) each rank's slab K1 / K2 / K3 (banded) against their
    plain twins, timed on rank 0 with bounds and a CSR product; (d)
    dryrun_multichip(2) on the card against the CPU float64 step and
    app.main --devices 2 at SHARDED_CLI_BOX against a one-process card
    step; (e) the Krylov options on the ranks (phase_sharded_options),
    beside (b) and phase 19's box-55 steps (`krylov_out`)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.main import RunFiles
    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel import launch
    from dedflow_tpu_torch.parallel.dryrun import dryrun_multichip
    from dedflow_tpu_torch.solver.newton import NSSolver

    out = {"backend": launch.backend_for(SHARDED_MAIN_RANKS, "cuda")}
    say(f"  ranks share {torch.cuda.device_count()} card(s): backend {out['backend']}")
    # (a) box 12 on 2 and 4 ranks against the CPU float64 step
    mesh, cfg = box_mesh(*SLICE_BOX), reference_scenario_config()
    cpu = NSSolver(mesh, cfg, device="cpu")
    *ref, rstats = cpu.step(*perturbed_state(mesh, "cpu", torch.float64))
    ref_kry = rstats.krylov_iters
    # the 2-rank slice runs in the spawn of (b), first
    t0 = time.perf_counter()
    res = launch.spawn(sharded_main_rank, SHARDED_MAIN_RANKS, "cuda", timeout=600)[0]
    out["main_call_s"] = time.perf_counter() - t0
    for world in SHARDED_SLICE_RANKS:
        t0 = time.perf_counter()
        got = res["slice"] if world == SHARDED_MAIN_RANKS else launch.spawn(
            sharded_slice_rank, world, "cuda", timeout=300)[0]
        worst = max(rel_err(torch.as_tensor(g), r)[1] for g, r in zip(got["state"], ref))
        where = ("in (b)'s process group" if world == SHARDED_MAIN_RANKS
                 else f"{time.perf_counter() - t0:.1f} s")
        say(f"  (a) box {SLICE_BOX} on {world} ranks ({where}): state "
            f"vs CPU f64 rel={worst:.3e}; newton {got['newton']} (CPU {len(rstats.rnorms)}), "
            f"krylov {got['krylov']} (CPU {ref_kry})")
        check(f"sharded slice {world} ranks", worst, TOL_SLICE)
        if got["newton"] != len(rstats.rnorms):
            raise PhaseError(f"sharded slice {world} ranks: Newton counts {got['newton']} vs "
                             f"{len(rstats.rnorms)}")
        if got["krylov"] != ref_kry:
            own, runs = krylov_witness(f"sharded {world}", mesh, cfg, got["krylov"], ref_kry)
            say(f"    krylov counts witnessed by plain float32 CPU steps ({runs} runs, own {own})")
        out[f"slice_{world}_rel"] = worst
    # (b) + (c) box 55 on 2 ranks
    ranks = res["ranks"]
    for r in ranks:
        say(f"  (b) rank {r['rank']}: {r['n_own']} own nodes, set-up {r['setup_s']:.2f} s, "
            f"launches K1/K2/K3-banded {r['launches']}, plain twins called {r['plain_calls']}, "
            f"peak {r['peak_bytes'] / 2**30:.3f} GiB")
        for i, s in enumerate(r["steps"], 1):
            say(f"    step {i}: {json.dumps(s)}")
        if min(r["launches"]) <= 0 or any(r["plain_calls"]):
            raise PhaseError(f"sharded main: rank {r['rank']} launches {r['launches']}, plain "
                             f"calls {r['plain_calls']}")
    one_newton = main_out["newton"][: len(ranks[0]["steps"])]
    newton = [s["newton"] for s in ranks[0]["steps"]]
    fields = []
    for c in range(6):
        g = np.concatenate([a[:, c] for a in res["state"]])
        rf = np.concatenate([a[:, c].numpy() for a in main_out["first_state"]])
        fields.append(float(np.abs(g - rf).max() / max(np.abs(rf).max(), 1e-300)))
    say(f"  (b) box {FULL_BOX} on {SHARDED_MAIN_RANKS} ranks vs phase 5: state rel per field "
        f"{[f'{v:.3e}' for v in fields]}; newton {newton} (phase 5 {one_newton})")
    check("sharded main state", max(fields), TOL_SLICE)
    if newton != one_newton:
        raise PhaseError(f"sharded main: Newton counts {newton} vs phase 5's {one_newton}")
    kms = dict(zip(("K1", "K2", "K3"), (row["ms"] for row in res["kernels"])))
    split = []
    nsteps = len(ranks[0]["steps"])
    for i in range(nsteps):
        s0 = [r["steps"][i] for r in ranks]
        kern = [(kms["K1"] * r["launches"][0] + kms["K2"] * r["launches"][1]
                 + kms["K3"] * r["launches"][2]) / nsteps for r in ranks]
        split.append({
            "wall_s": max(s["wall_s"] for s in s0),
            "kernels_s_est": max(kern) / 1e3,
            "bands_carries_s": max(s["exchange_s"] for s in s0),
            "allreduce_s": max(s["allreduce_s"] for s in s0),
            # of the two above, the staging copies' wait for the card's queue
            "staging_wait_s": max(s["stage_s"] for s in s0),
            "exchanges": s0[0]["exchanges"], "allreduces": s0[0]["allreduces"],
            "halo_bytes_per_newton": max(s["sent_bytes"] for s in s0) / s0[0]["newton"],
            "allreduces_per_krylov_iter": s0[0]["allreduces"] / max(sum(s0[0]["krylov"]), 1),
            "gmres_host_syncs": sum(1 + -(-k // 8) for k in s0[0]["krylov"]),
        })
        split[-1]["other_s"] = split[-1]["wall_s"] - split[-1]["kernels_s_est"] - split[-1][
            "bands_carries_s"] - split[-1]["allreduce_s"]
    out.update(main_state_rel=fields, main_newton=newton, main_split=split,
               main_step_s=[sp["wall_s"] for sp in split],
               one_process_step_s=main_out["step_s"][:nsteps],
               peak_gib=[r["peak_bytes"] / 2**30 for r in ranks])
    say(f"  (b) split per step: {json.dumps(split)}")
    # (d) the dry run and the CLI on the card
    t0 = time.perf_counter()
    dry = dryrun_multichip(2)
    dmesh = box_mesh(3, 3, 4)
    dref = NSSolver(dmesh, cfg, device="cpu").step_fixed(
        *state_from_numpy(*reference_initial_state(dmesh), device="cpu"), num_newton=2)
    drel = max(rel_err(torch.as_tensor(g), r)[1] for g, r in zip(dry, dref))
    say(f"  (d) dryrun_multichip(2) ({time.perf_counter() - t0:.1f} s): vs CPU f64 rel={drel:.3e}")
    check("dryrun_multichip(2)", drel, TOL_SLICE)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        files = RunFiles(write_solution=npz_write_solution, needs_h5py=False)
        rc, lines = cli(["--box", *map(str, SHARDED_CLI_BOX), "--steps", "1", "--save-every", "1",
                         "--devices", "2", "--out", tmp, "--log-level", "warning"], files)
        snap = dict(np.load(os.path.join(tmp, "sol.1.h5.npz")))
        recs = [json.loads(ln) for ln in open(os.path.join(tmp, "metrics.jsonl"))]
    cmesh = box_mesh(*SHARDED_CLI_BOX)
    one = NSSolver(cmesh, cfg, device="cuda")
    wg1 = one.step(*state_from_numpy(*reference_initial_state(cmesh), "cuda", torch.float32))[0]
    crel = rel_err(torch.as_tensor(snap["u"]).reshape(-1, 3), wg1[:, :3].cpu())[1]
    say(f"  (d) app.main --devices 2 at box {SHARDED_CLI_BOX} ({time.perf_counter() - t0:.1f} s): "
        f"rc {rc}, "
        f"metrics {recs}, sol.1 u vs a one-process card step rel={crel:.3e}")
    if rc != 0 or not recs or recs[0].get("ranks") != 2:
        raise PhaseError(f"app.main --devices 2: rc {rc}, metrics {recs}")
    check("app.main --devices 2", crel, TOL_SLICE)
    out.update(dryrun_rel=drel, cli_rel=crel)
    kernels = res["kernels"]
    launches = [sum(r["launches"][i] for r in ranks) for i in range(3)]
    t0 = time.perf_counter()
    opt_rows, out["options"] = phase_sharded_options(res, krylov_out)
    say(f"  (e): {time.perf_counter() - t0:.1f} s")
    return [dict(r, launches=n) for r, n in zip(kernels, launches)] + opt_rows, out


# Phase 25 (e): the Krylov options on z-slabs (ROADMAP A16 (d')): SIMPLE with
# its Schur bands across the seams, the shard-local multigrid, the "ir"
# refinement (K3's banded entry in float64) and the lagged Jacobian.
SHARDED_OPTION_BOX = (15, 15, 15)  # 16 node layers, 8 a rank on 2
SHARDED_OPTIONS = {"mg": ({"pc": "mg"}, False), "simple": ({"pc": "simple"}, False),
                   "ir": ({"precision": "ir"}, False), "lagged": ({}, True)}
# levels of the hierarchy at SHARDED_OPTION_BOX: one process 16^3 -> 8^3
# (512 < 1024 rows); a rank 16 x 16 x 8 -> 8 x 8 x 4 (256 < max(128, 1024 // 2))
SHARDED_OPTION_LEVELS = 2
SHARDED_OPTION_KERNELS = (
    ("K3 dia spmv banded (f64, slab, box-55 half)", "dedflow_tpu_torch/csrc/dia_spmv.cu",
     "dedflow_tpu/sparse/dia_kernels.py:169"),
)


def option_config(cfg, name: str):
    """`cfg` with the option `name` of SHARDED_OPTIONS."""
    import dataclasses

    krylov, lagged = SHARDED_OPTIONS[name]
    cfg = with_krylov(cfg, **krylov)
    if lagged:
        cfg = dataclasses.replace(cfg, newton=dataclasses.replace(cfg.newton, lag_jacobian=True))
    return cfg


def sharded_options_rank(device):
    """A rank of phase 25 (e). (i) box 15: one adaptive step from
    perturbed_state with each option of SHARDED_OPTIONS, the launches of
    K3's banded entry (float32, float64) counted over each step, the
    refinements of "ir", the hierarchy's levels with "mg"; (ii) box 55, pc
    "mg", one step from the reference initial state with its counts, the
    exchanges and all-reduces with their host seconds, peak memory, then the
    levels and the band exchanges of one MG apply; (iii) K3's float64
    banded entry on rank 0's slab against its plain twin, timed in turns
    while the other ranks wait. Rank 0 returns everything."""
    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.app.scenarios import reference_initial_state, reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
    from dedflow_tpu_torch.solver.newton import assemble_system
    from dedflow_tpu_torch.sparse import dia_kernels as dk
    from dedflow_tpu_torch.tools.timing import nbytes
    from dedflow_tpu_torch.utils import nvcc

    rank = dist.get_rank()
    counters = (dk.dia_matvec_banded, dk.dia_matvec_banded_f64)
    ref = reference_scenario_config()
    # (i)
    mesh = box_mesh(*SHARDED_OPTION_BOX)
    slices = {}
    for name in SHARDED_OPTIONS:
        solver = ShardedNSSolver(mesh, option_config(ref, name), device=device)
        state = [t[solver.own] for t in perturbed_state(mesh, device, solver.dtype)]
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        with RefineSpy() as spy:
            *new, stats = solver.step(*state)
        torch.cuda.synchronize()
        rec = {"state": [solver.gather_state(t) for t in new], "newton": len(stats.rnorms),
               "krylov": stats.krylov_iters, "launches": [c.launches for c in counters],
               "refines": spy.runs}
        if name == "mg":
            _, pc = assemble_system(solver.sctx, solver.face_ctxs, solver.mask_t, *state,
                                    ref.physics, ref.time, pc_type="mg")
            rec["levels"] = len(pc.levels)
        slices[name] = rec
        del solver
    # (ii)
    t0 = time.perf_counter()
    mesh = box_mesh(*FULL_BOX)
    cfg = option_config(ref, "mg")
    solver = ShardedNSSolver(mesh, cfg, device=device)
    state = [solver.shard_state(a) for a in reference_initial_state(mesh)]
    setup_s = time.perf_counter() - t0
    comm = solver.comm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    comm.stats.reset()
    dist.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    *new, stats = solver.step(*state)
    torch.cuda.synchronize()
    s = comm.stats
    step = {"wall_s": time.perf_counter() - t1, "newton": len(stats.rnorms),
            "krylov": stats.krylov_iters, "converged": stats.converged,
            "exchanges": s.exchanges, "exchange_s": s.exchange_s, "sent_bytes": s.sent_bytes,
            "allreduces": s.allreduces, "allreduce_s": s.allreduce_s, "stage_s": s.stage_s,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    full = [solver.gather_state(t) for t in new]
    jm, pc = assemble_system(solver.sctx, solver.face_ctxs, solver.mask_t, *state, cfg.physics,
                             cfg.time, pc_type="mg")
    gen = torch.Generator(device=device).manual_seed(SEED + rank)
    xp = torch.randn((6, solver.sctx.n_own), generator=gen, device=device)
    torch.cuda.synchronize()
    comm.stats.reset()
    t2 = time.perf_counter()
    pc(xp)
    torch.cuda.synchronize()
    apply = {"levels": len(pc.levels), "dims": [lv.dims for lv in pc.levels],
             "exchanges": comm.stats.exchanges, "allreduces": comm.stats.allreduces,
             "wall_s": time.perf_counter() - t2, "exchange_s": comm.stats.exchange_s}
    rec = {"rank": rank, "n_own": solver.sctx.n_own, "setup_s": setup_s, "step": step,
           "apply": apply}
    # (iii) K3's float64 banded entry on rank 0's slab
    row = None
    dist.barrier()
    if rank == 0:
        sctx = solver.sctx
        left = sctx.width if comm.left is not None else 0
        m = left + sctx.n_own + (sctx.width if comm.right is not None else 0)
        d64, s64 = jm.data.double(), jm.scal.double()
        x64 = torch.randn((6, m), generator=gen, device=device, dtype=torch.float64)
        offs, n = jm.offsets, sctx.n_own
        pieces = []
        for k, o in enumerate(offs):
            rr = torch.arange(max(0, -o - left), min(n, m - left - o), device=device)
            by_comp = {c: d64[k, c, rr] for c in range(16)}
            by_comp.update({16: s64[2 * k, rr], 17: s64[2 * k + 1, rr]})
            pieces.append((rr, rr + left + o, by_comp))
        csr, xflat = block_csr(n, pieces, cols=m), x64.reshape(-1)
        k3 = lambda: dk.dia_matvec_banded(d64, s64, x64, offs, left)
        p3 = lambda: dk.dia_matvec_banded_plain(d64, s64, x64, offs, left)
        out6 = torch.empty((6, n), dtype=torch.float64)
        row = f64_record(SHARDED_OPTION_KERNELS[0][0], k3, p3, nbytes(d64, s64, x64, out6),
                         op_count(p3), (lambda: csr @ xflat, k3()), dk.dia_matvec_banded_f64)
        row = (row, registers(nvcc.load(["dia_spmv"])["dia_spmv"], "dia_spmv_kernelIdE"))
        del csr, pieces
    dist.barrier()
    recs = [None] * comm.world if rank == 0 else None
    dist.gather_object(rec, recs, dst=0)
    if rank == 0:
        return {"slices": slices, "ranks": recs, "state": full, "kernel": row}


def phase_sharded_options(res_b: dict, krylov_out: dict) -> tuple[list, dict]:
    """Phase 25 (e) on 2 gloo ranks sharing the card (sharded_options_rank,
    while this process steps the CPU float64 references): (i) box 15 with
    each of SHARDED_OPTIONS against the CPU float64 one-process step with
    the same option (TOL_SLICE, equal Newton counts, Krylov counts equal or
    witnessed by plain float32 CPU steps; "ir": every refined solve at
    IR_BAR; "mg": SHARDED_OPTION_LEVELS levels on the ranks and in one
    process; K3's float64 banded entry launched in the "ir" step); (ii) box
    55 with pc "mg": Newton's iterations and outcome (converged or not)
    those of phase 19's one-process MG step, the step's counts beside (b)'s
    fieldsplit step and phase 19's one-process MG step, levels a rank, band
    exchanges an MG apply, all-reduces and exchanges a step with their host
    seconds, peak memory, the state's distance from (b)'s; (iii) K3's
    float64 banded row. Returns ([the row], summary)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.scenarios import reference_scenario_config
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel import launch
    from dedflow_tpu_torch.solver.newton import NSSolver, assemble_system

    out = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        run = pool.submit(launch.spawn, sharded_options_rank, SHARDED_MAIN_RANKS, "cuda",
                          timeout=600)
        mesh, ref = box_mesh(*SHARDED_OPTION_BOX), reference_scenario_config()
        cpu = {}
        for name in SHARDED_OPTIONS:
            cfg = option_config(ref, name)
            solver = NSSolver(mesh, cfg, device="cpu")
            state = perturbed_state(mesh, "cpu", torch.float64)
            *st, stats = solver.step(*state)
            levels = None
            if name == "mg":
                _, pc = assemble_system(solver.lctx, solver.face_ctxs, solver.mask_t, *state,
                                        ref.physics, ref.time, pc_type="mg")
                levels = len(pc.levels)
            cpu[name] = (st, stats, levels)
        cpu_s = time.perf_counter() - t0
        res = run.result()[0]
    out["call_s"] = time.perf_counter() - t0
    say(f"  (e) CPU float64 references {cpu_s:.1f} s, the ranks' call {out['call_s']:.1f} s")
    inputs = lambda mesh, cfg, device, dtype: (perturbed_state(mesh, device, dtype), None)
    for name, got in res["slices"].items():
        st, stats, levels = cpu[name]
        worst = max(rel_err(torch.as_tensor(g), r)[1] for g, r in zip(got["state"], st))
        line = (f"  (e)(i) box {SHARDED_OPTION_BOX} {name} on {SHARDED_MAIN_RANKS} ranks: state vs "
                f"CPU f64 rel={worst:.3e}; newton {got['newton']} (CPU {len(stats.rnorms)}), "
                f"krylov {got['krylov']} (CPU {stats.krylov_iters}); K3 banded f32 / f64 "
                f"launches {got['launches']}")
        if name == "ir":
            rels = [r for _, _, r in got["refines"]]
            line += f"; refinements (cycles, inner, rel) {got['refines']}"
            if not rels or max(rels) > IR_BAR:
                raise PhaseError(f"sharded option ir: a refined solve ended at {rels}")
            if min(got["launches"]) <= 0:
                raise PhaseError(f"sharded option ir: K3 banded launches {got['launches']}")
            out["k3_f64_banded_launches"] = got["launches"][1]
        if name == "mg":
            line += f"; levels: ranks {got['levels']}, one process {levels}"
            if not got["levels"] == levels == SHARDED_OPTION_LEVELS:
                raise PhaseError(f"sharded option mg: levels {got['levels']} / {levels}, not "
                                 f"{SHARDED_OPTION_LEVELS}")
        say(line)
        check(f"sharded option {name}", worst, TOL_SLICE)
        if got["newton"] != len(stats.rnorms):
            raise PhaseError(f"sharded option {name}: Newton counts {got['newton']} vs "
                             f"{len(stats.rnorms)}")
        if got["krylov"] != stats.krylov_iters:
            own, runs = krylov_witness(f"sharded option {name}", mesh, option_config(ref, name),
                                       got["krylov"], stats.krylov_iters, inputs=inputs)
            say(f"    krylov counts witnessed by plain float32 CPU steps ({runs} runs, own {own})")
        out[f"slice_{name}_rel"] = worst
    # (ii)
    ranks = res["ranks"]
    fs = res_b["ranks"][0]["steps"][0]
    one_mg = krylov_out["box55 mg"]
    for r in ranks:
        st, ap = r["step"], r["apply"]
        say(f"  (e)(ii) rank {r['rank']}: {r['n_own']} own nodes, set-up {r['setup_s']:.2f} s, "
            f"step {json.dumps({k: v for k, v in st.items()})}; MG apply: {ap['levels']} levels "
            f"{ap['dims']}, {ap['exchanges']} band exchanges, {ap['allreduces']} all-reduces, "
            f"{ap['wall_s']:.4f} s ({ap['exchange_s']:.4f} s exchanging)")
        if st["converged"] != one_mg["converged"] or st["newton"] != one_mg["newton"]:
            raise PhaseError(f"sharded mg box 55: rank {r['rank']}'s Newton {st['newton']} "
                             f"iterations, converged {st['converged']}; one process (phase 19) "
                             f"{one_mg['newton']}, converged {one_mg['converged']}")
    st0 = ranks[0]["step"]
    per_newton = [k for k in st0["krylov"]]
    fields = []
    for c in range(6):
        g = np.concatenate([a[:, c] for a in res["state"]])
        rf = np.concatenate([a[:, c] for a in res_b["state"]])
        fields.append(float(np.abs(g - rf).max() / max(np.abs(rf).max(), 1e-300)))
    say(f"  (e)(ii) box {FULL_BOX} pc mg on {SHARDED_MAIN_RANKS} ranks: s/step "
        f"{max(r['step']['wall_s'] for r in ranks):.3f}, krylov a Newton iteration {per_newton} "
        f"(fieldsplit in (b): {fs['krylov']} at {fs['wall_s']:.3f} s; one process pc mg, phase "
        f"19: {one_mg['krylov']} at {one_mg['step_s']:.3f} s, converged {one_mg['converged']}); "
        f"converged {st0['converged']}; state vs (b)'s per field "
        f"{fmt_list(fields)}")
    out.update(
        mg_step_s=max(r["step"]["wall_s"] for r in ranks), mg_newton=st0["newton"],
        mg_krylov=per_newton, fieldsplit_krylov=fs["krylov"], fieldsplit_step_s=fs["wall_s"],
        one_process_mg_krylov=one_mg["krylov"], one_process_mg_step_s=one_mg["step_s"],
        mg_levels=[r["apply"]["levels"] for r in ranks],
        mg_apply_exchanges=[r["apply"]["exchanges"] for r in ranks],
        mg_apply_s=[r["apply"]["wall_s"] for r in ranks],
        mg_step_exchanges=[r["step"]["exchanges"] for r in ranks],
        mg_step_exchange_s=[r["step"]["exchange_s"] for r in ranks],
        mg_step_allreduces=[r["step"]["allreduces"] for r in ranks],
        mg_step_allreduce_s=[r["step"]["allreduce_s"] for r in ranks],
        mg_peak_gib=[r["step"]["peak_bytes"] / 2**30 for r in ranks],
        mg_state_vs_fieldsplit=fields)
    row, out["k3_f64_banded_registers"] = res["kernel"]
    say(f"  (e)(iii) K3 f64 banded: registers {out['k3_f64_banded_registers']}")
    return [dict(row, launches=out["k3_f64_banded_launches"])], out


# ---------------------------------------------------------------------------
# Phase 26: the RCB mode (parallel.sharded, ROADMAP A16 (b')): any tet mesh
# RCB-partitioned onto the gather tier, each rank's part with its halo.

RCB_SLICE_POINTS = 500  # delaunay_mesh(500, seed=7): tests/test_sharding.py:77-110's mesh
RCB_SLICE_SEED = 7
RCB_SLICE_RANKS = (2, 4)
RCB_MAIN_RANKS = 2
RCB_MELT_BOX = SLICE_BOX
# The slices' bar: TOL_SLICE, or where a plain float32 CPU step itself lies
# farther from the float64 step than that (the Delaunay slice), this factor
# times its distance: the card's float32 step sums in other orders.
RCB_F32_FACTOR = 2.0
# (b)'s step at full width: fieldsplit GMRES stalls at its 120 cap on
# this mesh (its float32 linear residuals end at 0.4-0.8 on the card after
# the first Newton iteration), so a one-process step from the input times
# (1 + 1e-7 N(0, 1)) lands 2-3e-2 from the step, field by field. F, J x
# and P x are held at TOL_SLICE; the step's fields within
# RCB_WITNESS_FACTOR times the largest such distance of RCB_WITNESSES
# witness steps (or TOL_SLICE where that is larger).
RCB_WITNESSES = 3
RCB_WITNESS_EPS = 1e-7
RCB_WITNESS_FACTOR = 5.0
# the CLI's --mesh (an .npz here: no h5py): a converted box's file, nodes
# shuffled (mesh.gen.shuffled_mesh), read without lattice recovery: no
# lattice metadata, no translation classes, the reference scenario's walls
RCB_CLI_BOX = (10, 8, 9)
RCB_CONFIG = dict(bcs=(), pin_pressure=True)
RCB_KERNELS = (
    ("K4 gathered element residual staged (RCB part, Delaunay half)",
     "dedflow_tpu_torch/csrc/gather_elements.cu", "dedflow_tpu/fem/pallas_kernels.py:434"),
    ("K5 gathered element jacobian staged (RCB part, Delaunay half)",
     "dedflow_tpu_torch/csrc/gather_elements.cu", "dedflow_tpu/fem/pallas_kernels.py:507"),
    ("K7 winell spmv halo (RCB part, Delaunay half)", "dedflow_tpu_torch/csrc/winell_spmv.cu",
     "dedflow_tpu/sparse/win_kernels.py:213"),
    ("K8 segment sum (RCB part, Delaunay half)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_stream.py:432"),
    ("K9 segment sum (RCB part, Delaunay half)", "dedflow_tpu_torch/csrc/seg_reduce.cu",
     "dedflow_tpu/sparse/win_ring.py:622"),
)


def rcb_config(**kw):
    """The gather tier's configuration of the Delaunay cells (bench.py's
    settings, phase 14), use_lattice "gather" as the RCB mode runs it."""
    from dedflow_tpu_torch.app.scenarios import reference_scenario_config

    return reference_scenario_config(**RCB_CONFIG, use_lattice="gather", **kw)


def field_errs(got, ref) -> list:
    """Each field's largest error over its own largest value: the states
    (N, C) of `got` (numpy or torch) against `ref` (torch), state by state,
    component by component."""
    import torch

    return [rel_err(torch.as_tensor(g)[:, c], r[:, c])[1]
            for g, r in zip(got, ref) for c in range(r.shape[1])]


def fmt_list(vals) -> str:
    return "[" + ", ".join(f"{v:.3e}" for v in vals) + "]"


def rcb_slice_mesh():
    from dedflow_tpu_torch.mesh.gen import delaunay_mesh

    return delaunay_mesh(RCB_SLICE_POINTS, seed=RCB_SLICE_SEED)


def rcb_slice_inputs(mesh, cfg, device, dtype) -> dict:
    """Phase 26 (a) / (d)'s inputs, name -> (state, source): the melt pool's
    perturbed state and laser source; on the Delaunay slice perturbed_state
    (the step's small fields are float32 noise of a uniform flow) and
    perturbed_flow_state (every field a scale of its own)."""
    if cfg.implicit_scalars:
        return {"melt": slice_inputs(mesh, cfg, device, dtype)}
    return {"perturbed": (perturbed_state(mesh, device, dtype), None),
            "flow": (perturbed_flow_state(mesh, device, dtype), None)}


def rcb_slice_rank(device, mesh=None, cfg=None):
    """A rank of phase 26 (a) or (d): one adaptive step on `mesh` (the
    Delaunay slice by default) from each of its rcb_slice_inputs; rank 0
    returns, per input, the gathered state and the counts."""
    import torch.distributed as dist

    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver

    mesh = rcb_slice_mesh() if mesh is None else mesh
    cfg = rcb_config() if cfg is None else cfg
    solver = ShardedNSSolver(mesh, cfg, device=device)
    if solver.mode != "rcb":
        raise PhaseError(f"rcb slice: mode {solver.mode!r}")
    own = torch_index(solver.own, device)
    out = {}
    for key, (state, src) in rcb_slice_inputs(mesh, cfg, device, solver.dtype).items():
        *new, stats = solver.step(*(t[own] for t in state),
                                  source=None if src is None else src[own])
        out[key] = {"state": [solver.gather_state(t) for t in new], "newton": len(stats.rnorms),
                    "krylov": stats.krylov_iters}
    if dist.get_rank() == 0:
        return out


def torch_index(idx, device):
    import torch

    return torch.as_tensor(idx, dtype=torch.long, device=device)


def rcb_compare(tag: str, pairs: dict) -> dict:
    """compare() for the RCB parts: each kernel run twice (bit-identical,
    finite) and its plain twin once on this rank's part; the tolerance is
    held by the parts' outputs together, the distributed function's whole
    output (the largest error of any rank over the largest value of any
    rank, per view): a part's own largest value is a chance of the cut,
    and a part's rows are the whole function's rows. Returns {kernel: the
    largest abs error over every rank}."""
    import torch
    import torch.distributed as dist

    mine = {}
    for key, (kern, plain, _, parts) in pairs.items():
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or not torch.equal(got, again):
            raise PhaseError(f"{tag} {key}: non-finite, or two runs of the kernel differ")
        mine[key] = {name: (float((view(got).double() - view(ref).double()).abs().max()),
                            float(view(ref).double().abs().max())) for name, view in parts.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    errs = {}
    for key, (_, _, tol, parts) in pairs.items():
        for name in parts:
            err = max(e[key][name][0] for e in every)
            scale = max(e[key][name][1] for e in every)
            own_rel = mine[key][name][0] / max(mine[key][name][1], 1e-300)
            say(f"  {tag} {key}{name}: max_abs_err={mine[key][name][0]:.3e} (own rel "
                f"{own_rel:.3e}); every part: max_abs_err={err:.3e} rel={err / max(scale, 1e-300):.3e}"
                f" (tol {tol:.0e})")
            check(f"{tag} {key}{name}", err / max(scale, 1e-300), tol)
            errs[key] = max(errs.get(key, 0.0), err)
    return errs


def rcb_part_records(solver, wg, dwgold, dwg) -> list | None:
    """Phase 26 (c) on this rank: its part's K4 staged, K5 staged, K7 halo
    entry, K8's and K9's segment sums against their plain twins at the
    given own rows of a state (rcb_compare; the staged rows and the segment
    sums also against the column kernels' route over the same elements,
    bit for bit); then, on
    rank 0 while the others wait, their records with bounds and library
    calls (a CSR product over the local vector, index_add). Returns the
    records on rank 0, else None."""
    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.fem import win_assembly as wa_
    from dedflow_tpu_torch.fem.element_rows import alpha_states
    from dedflow_tpu_torch.fem.ns import part_states
    from dedflow_tpu_torch.solver.newton import assemble_system
    from dedflow_tpu_torch.sparse.win_kernels import winell_matvec_halo, winell_matvec_plain
    from dedflow_tpu_torch.sparse.win_ring import (
        ring_reduce,
        ring_reduce_staged,
        ring_reduce_staged_plain,
    )
    from dedflow_tpu_torch.sparse.win_stream import (
        stream_reduce,
        stream_reduce_staged,
        stream_reduce_staged_plain,
    )
    from dedflow_tpu_torch.sparse.winell import COMP2WIN
    from dedflow_tpu_torch.tools.timing import nbytes

    rank, cfg, ctx = dist.get_rank(), solver.cfg, solver.gctx
    phys, scheme, ne = cfg.physics, cfg.time, ctx.num_elem
    wa, dwa = alpha_states(wg, dwgold, dwg, scheme)
    w, dw, _ = part_states(solver.pctx, wa, dwa)  # (n_x, 6) local states
    w_t, dw_t = w.T.contiguous(), dw.T.contiguous()
    jm, _ = assemble_system(solver.pctx, solver.face_ctxs, solver.mask_t, wg, dwgold, dwg, phys,
                            scheme)
    (rng,) = ctx.ranges
    rplan, jplan = rng.res_plan, rng.jac_plan
    n_own, n_x = jm.plan.num_node, solver.comm.plan.n_x
    gen = torch.Generator(device=w.device).manual_seed(SEED + rank)
    x = torch.randn((6, n_x), generator=gen, device=w.device, dtype=w.dtype)
    stage8 = ek.ns_residual_gather_staged(ctx.res_geom, ctx.ien_t, w, dw, phys, scheme, rplan)
    stage16 = ek.ns_lhs_gather_staged(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme, jplan)[0]
    by_eq, entry_blocks = reduce_parts()
    pairs = {  # name: (kernel, plain, tolerance, parts)
        "K4": (lambda: ek.ns_residual_gather_staged(ctx.res_geom, ctx.ien_t, w, dw, phys, scheme,
                                                    rplan),
               lambda: ek.ns_residual_gather_staged_plain(ctx.res_geom, ctx.ien_t, w, dw, phys,
                                                          scheme, rplan),
               TOL_K4, {" [rows]": lambda t: t[:, :6], " [padding]": lambda t: t[:, 6:]}),
        "K5": (lambda: ek.ns_lhs_gather_staged(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme,
                                               jplan)[0],
               lambda: ek.ns_lhs_gather_staged_plain(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme,
                                                     jplan)[0],
               TOL_K5, staged_blocks(False)),
        "K7": (lambda: winell_matvec_halo(jm, x), lambda: winell_matvec_plain(jm, x, n_x),
               TOL_K7, by_eq),
        "K8": (lambda: stream_reduce_staged(rplan, stage8, 6),
               lambda: stream_reduce_staged_plain(rplan, stage8, 6), TOL_K8, by_eq),
        "K9": (lambda: ring_reduce_staged(jplan, stage16, 16),
               lambda: ring_reduce_staged_plain(jplan, stage16, 16), TOL_K9, entry_blocks),
    }
    tag = f"rank {rank} RCB part"
    errs = rcb_compare(tag, pairs)
    # the staged rows and their segment sums equal the column kernels' route
    rows24 = ek.ns_residual_gather(ctx.res_geom, ctx.ien_t, w_t, dw_t, phys, scheme)
    rows288 = ek.ns_lhs_gather(ctx.lhs_geom, ctx.ien_t, w_t, phys, scheme)
    same = {"K4": torch.equal(stage8, ek.stage_residual_rows(rplan, rows24)),
            "K5": torch.equal(stage16, ek.stage_rows(jplan, rows288)[0]),
            "K8": torch.equal(pairs["K8"][0](), stream_reduce(rplan, rows24, range(6), ne)),
            "K9": torch.equal(pairs["K9"][0](), ring_reduce(jplan, rows288, wa_.JAC_COMPS, ne))}
    say(f"  (c) {tag}: {n_own} own rows, {n_x - n_own} ghosts, {ne} elements, {jm.plan.S} "
        f"entries; == the column kernels' route, bit for bit: {same}")
    if not all(same.values()):
        raise PhaseError(f"{tag}: the staged route differs from the column kernels' {same}")
    del rows24, rows288
    rows = None
    dist.barrier()
    if rank == 0:  # the other ranks wait: one process on the card while it is timed
        k = rplan.src.numel()
        csr = block_csr(n_own, [(jm.plan.grow_t.long(), jm.plan.col_t.long(),
                                 {c: jm.vals[int(COMP2WIN[c])] for c in range(18)})], cols=n_x)
        xflat, out6 = x.reshape(-1), torch.empty((6, n_own), dtype=torch.float32)
        index_add = {}
        for key, plan, stage, nrow in (("K8", rplan, stage8, 6), ("K9", jplan, stage16, 16)):
            tgt = torch.repeat_interleave(torch.diff(plan.ptr.long()))
            zeros = torch.zeros((plan.num_tgt, stage.shape[1]), dtype=stage.dtype,
                                device=stage.device)
            index_add[key] = (lambda z=zeros, t=tgt, st=stage, r=nrow:
                              torch.index_add(z, 0, t, st).T[:r], pairs[key][0]())
        spec = {  # name: (reps, bytes, library)
            "K4": (20, nbytes(ctx.res_geom, ctx.ien_t, w, dw, rplan.elem_pos) + 4 * 6 * k, None),
            "K5": (10, nbytes(ctx.lhs_geom, ctx.ien_t, w_t[:3], jplan.elem_pos, stage16), None),
            "K7": (100, nbytes(jm.vals, jm.plan.col_t, jm.plan.row_ptr_t, x, out6),
                   (lambda: csr @ xflat, pairs["K7"][0]())),
            "K8": (50, nbytes(rplan.ptr, stage8[:, :6], out6), index_add["K8"]),
            "K9": (20, nbytes(jplan.ptr, stage16, torch.empty((16, jplan.num_tgt))),
                   index_add["K9"]),
        }
        rows = [finish(name, {"max_abs_err": errs[key]}, pairs[key][0], pairs[key][1], reps, 3,
                       nb, op_count(pairs[key][1]), library=lib)
                for (name, _, _), (key, (reps, nb, lib)) in zip(RCB_KERNELS, spec.items())]
        del csr, index_add
    dist.barrier()
    return rows


def rcb_main_rank(device, raw):
    """A rank of phase 26 (a) 2-rank, (b), (c) and (d). (a): the Delaunay
    slice (rcb_slice_rank). (d): the melt pool on a box-12 gather RCB. (b):
    ShardedNSSolver on the full Delaunay mesh `raw` (phase 14's, generated
    order) at perturbed_flow_state(raw) (phase 14's gather_perturbed_step
    is its reference): F, J x and P x (rcb_operator), then one adaptive
    step, the launch counts set to 0 just before and read just after (the
    plain twins and the whole-matrix K7 counted too: they must not run),
    the step's split from CommStats, ghosts, bytes per exchange, peak
    memory; the gathered state. (c): rcb_part_records on the same input
    state. Rank 0 returns everything."""
    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.app.scenarios import melt_pool_scenario_config
    from dedflow_tpu_torch.fem import element_kernels as ek
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
    from dedflow_tpu_torch.sparse import win_kernels as wk
    from dedflow_tpu_torch.sparse import win_ring, win_stream

    rank = dist.get_rank()
    slice_out = rcb_slice_rank(device)
    melt_out = rcb_slice_rank(device, box_mesh(*RCB_MELT_BOX),
                              melt_pool_scenario_config(use_lattice="gather"))
    t0 = time.perf_counter()
    solver = ShardedNSSolver(raw, rcb_config(), device=device)
    own = torch_index(solver.own, device)
    inputs = [t[own] for t in perturbed_flow_state(raw, device, solver.dtype)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = rcb_probe_vector(raw.num_node, device, solver.dtype)[:, own].contiguous()
    operator = {k: solver.gather_state(v) for k, v in rcb_operator(solver, inputs, x).items()}
    counters = (ek.ns_residual_gather_staged, ek.ns_lhs_gather_staged, wk.winell_matvec_halo,
                win_stream.stream_reduce_staged, win_ring.ring_reduce_staged)
    absent = (wk.winell_matvec, ek.ns_residual_gather, ek.ns_lhs_gather)
    plains = ((ek, "ns_residual_gather_staged_plain"), (ek, "ns_lhs_gather_staged_plain"),
              (wk, "winell_matvec_plain"), (win_stream, "stream_reduce_staged_plain"),
              (win_ring, "ring_reduce_staged_plain"))
    plain_calls = [[0] for _ in plains]
    originals = [getattr(m, n) for m, n in plains]
    for (m, n), f, calls in zip(plains, originals, plain_calls):
        setattr(m, n, _counting(f, calls))
    comm = solver.comm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters, *absent):
        c.launches = 0
    comm.stats.reset()
    dist.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    *state, stats = solver.step(*inputs)
    torch.cuda.synchronize()
    s = comm.stats
    step = {"wall_s": time.perf_counter() - t1, "newton": len(stats.rnorms),
            "krylov": stats.krylov_iters, "exchanges": s.exchanges, "sent_bytes": s.sent_bytes,
            "exchange_s": s.exchange_s, "allreduces": s.allreduces,
            "allreduce_s": s.allreduce_s, "stage_s": s.stage_s,
            "linear_rels": [float(v) for v in stats.linear_rels or ()]}
    launches = [c.launches for c in counters]
    off = [c.launches for c in absent]
    for (m, n), f in zip(plains, originals):
        setattr(m, n, f)
    plan = comm.plan
    rec = {"rank": rank, "n_own": plan.n_own, "n_ghost": plan.n_ghost,
           "elements": solver.gctx.num_elem, "entries": solver.gctx.win_plan.S,
           "peers": {q: len(i) for q, i in plan.send.items()}, "setup_s": setup_s,
           "step": step, "launches": launches, "absent": off,
           "plain_calls": [c[0] for c in plain_calls],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    full = [solver.gather_state(t) for t in state]
    rows = rcb_part_records(solver, *inputs)
    recs = [None] * comm.world if rank == 0 else None
    dist.gather_object(rec, recs, dst=0)
    if rank == 0:
        return {"ranks": recs, "state": full, "operator": operator, "newton": len(stats.rnorms),
                "krylov": stats.krylov_iters, "kernels": rows, "slice": slice_out,
                "melt": melt_out}


# Phase 26 (f): the Krylov options on RCB parts (ROADMAP A16 (d')): SIMPLE
# through K7's halo entry, "ir" (K7's halo entry in float64 for its
# residuals), and "mg", which warns and runs SIMPLE as on the gather tier.
RCB_OPTIONS = {"simple": ({"pc": "simple"}, False), "ir": ({"precision": "ir"}, False),
               "mg": ({"pc": "mg"}, False)}
RCB_MG_WARNING = "krylov.pc='mg' requires the lattice fast path"


def rcb_options_rank(device):
    """A rank of phase 26 (f): one adaptive step of the Delaunay slice from
    perturbed_flow_state with each of RCB_OPTIONS, the float32 and float64
    launches of K7's halo entry counted over each step, the warnings it
    raised and the refinements of "ir"; rank 0 returns them with the
    gathered states."""
    import warnings

    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.parallel.sharded import ShardedNSSolver
    from dedflow_tpu_torch.sparse import win_kernels as wk

    mesh = rcb_slice_mesh()
    halo, kernel = wk.winell_matvec_halo, wk._kernel
    f64_calls = [0]

    def counting(mat, x_t):  # the launch of every K7 product; on RCB parts the halo entry's
        f64_calls[0] += x_t.dtype == torch.float64
        return kernel(mat, x_t)

    out = {}
    for name, (krylov, _) in RCB_OPTIONS.items():
        solver = ShardedNSSolver(mesh, with_krylov(rcb_config(), **krylov), device=device)
        own = torch_index(solver.own, device)
        state = [t[own] for t in perturbed_flow_state(mesh, device, solver.dtype)]
        halo.launches, f64_calls[0] = 0, 0
        wk._kernel = counting
        try:
            with warnings.catch_warnings(record=True) as caught, RefineSpy() as spy:
                warnings.simplefilter("always")
                *new, stats = solver.step(*state)
        finally:
            wk._kernel = kernel
        out[name] = {"state": [solver.gather_state(t) for t in new], "newton": len(stats.rnorms),
                     "krylov": stats.krylov_iters, "launches": halo.launches,
                     "f64_launches": f64_calls[0], "refines": spy.runs,
                     "warned": sorted({str(w.message) for w in caught})}
    if dist.get_rank() == 0:
        return out


def phase_rcb_options() -> dict:
    """Phase 26 (f): the Delaunay slice of (a) on 2 gloo ranks with each of
    RCB_OPTIONS (rcb_options_rank) against the CPU float64 one-process
    gather step with the same option, from perturbed_flow_state: (a)'s bar
    (TOL_SLICE, or RCB_F32_FACTOR times a plain float32 CPU step's
    distance), equal Newton counts; "ir": K7's halo entry launched in
    float64, every refined solve at IR_BAR; "mg": the gather tier's warning
    on the ranks, and the states bit-equal to "simple"'s."""
    import torch

    from dedflow_tpu_torch.parallel import launch
    from dedflow_tpu_torch.solver.newton import NSSolver

    out = {}
    t0 = time.perf_counter()
    res = launch.spawn(rcb_options_rank, RCB_MAIN_RANKS, "cuda", timeout=300)[0]
    out["call_s"] = time.perf_counter() - t0
    mesh = rcb_slice_mesh()
    for name, (krylov, _) in RCB_OPTIONS.items():
        cfg = with_krylov(rcb_config(), **krylov)
        got = res[name]
        *ref, rstats = NSSolver(mesh, cfg, device="cpu").step(
            *perturbed_flow_state(mesh, "cpu", torch.float64))
        f32 = NSSolver(mesh, cfg, device="cpu", dtype=torch.float32)
        f32_rel = max(rel_err(g, r)[1] for g, r in zip(
            f32.step(*perturbed_flow_state(mesh, "cpu", torch.float32))[:3], ref))
        bar = max(TOL_SLICE, RCB_F32_FACTOR * f32_rel)
        worst = max(rel_err(torch.as_tensor(g), r)[1] for g, r in zip(got["state"], ref))
        line = (f"  (f) delaunay flow pc/precision {name} on {RCB_MAIN_RANKS} ranks: state vs CPU "
                f"f64 rel={worst:.3e} (bar {bar:.3e}: a plain float32 CPU step's {f32_rel:.3e}); "
                f"newton {got['newton']} (CPU {len(rstats.rnorms)}), krylov {got['krylov']} (CPU "
                f"{rstats.krylov_iters}); K7 halo launches {got['launches']} (float64 "
                f"{got['f64_launches']}); warnings {got['warned']}")
        if name == "ir":
            rels = [r for _, _, r in got["refines"]]
            line += f"; refinements (cycles, inner, rel) {got['refines']}"
            if not rels or max(rels) > IR_BAR or got["f64_launches"] <= 0:
                raise PhaseError(f"rcb option ir: refinements {got['refines']}, float64 K7 "
                                 f"halo launches {got['f64_launches']}")
        if name == "mg":
            same = all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                       for a, b in zip(got["state"], res["simple"]["state"]))
            line += f"; states bit-equal to simple's: {same}"
            if not same or not any(RCB_MG_WARNING in w for w in got["warned"]):
                raise PhaseError(f"rcb option mg: warned {got['warned']}, equal to simple {same}")
        say(line)
        check(f"rcb option {name}", worst, bar)
        if got["newton"] != len(rstats.rnorms):
            raise PhaseError(f"rcb option {name}: Newton counts {got['newton']} vs "
                             f"{len(rstats.rnorms)}")
        if got["launches"] <= 0:
            raise PhaseError(f"rcb option {name}: K7's halo entry was not launched")
        out[name] = {"rel": worst, "bar": bar, "newton": got["newton"], "krylov": got["krylov"],
                     "cpu_krylov": rstats.krylov_iters, "k7_halo_launches": got["launches"],
                     "k7_halo_f64_launches": got["f64_launches"]}
    return out


BOUNDARY_FIELDS = ("nodes", "ien", "f2e", "forn")


def npz_write_mesh(path, mesh) -> None:
    """A tet mesh with its boundary tables as an .npz: the --mesh file of
    phase 26 (e) (the card machine has no h5py)."""
    import numpy as np

    tables = {f"b{i}_{f}": getattr(b, f) for i, b in enumerate(mesh.boundaries)
              for f in BOUNDARY_FIELDS}
    np.savez(path, xg=mesh.xg, ien=mesh.ien, **tables)


def npz_read_mesh(path):
    """The mesh npz_write_mesh wrote (RunFiles.read_mesh of phase 26 (e))."""
    import numpy as np

    from dedflow_tpu_torch.mesh.mesh import Boundary, Mesh

    with np.load(path) as d:
        nb = len([k for k in d.files if k.endswith("_forn")])
        return Mesh(xg=d["xg"], ien=d["ien"], boundaries=[
            Boundary(*(d[f"b{i}_{f}"] for f in BOUNDARY_FIELDS)) for i in range(nb)])


def phase_rcb(ga_main: dict, raw) -> tuple[list, dict]:
    """Phase 26: (a) the Delaunay slice (delaunay_mesh(500, seed=7)) on 2
    and 4 gloo ranks sharing the card, one adaptive step from each of its
    rcb_slice_inputs against the CPU float64 one-process gather step and a
    one-process card step on the same input (TOL_SLICE, or RCB_F32_FACTOR
    times a plain float32 CPU step's distance from float64 where that is
    larger; equal Newton counts, Krylov counts equal or witnessed by plain
    float32 CPU steps); (b) the full Delaunay mesh of phase 14 (1,181,683
    tets, generated order) on 2 ranks at perturbed_flow_state against
    phase 14's one-process solver (gather_perturbed_step): F, J x and P x
    each field within TOL_SLICE; one adaptive step with equal Newton and
    Krylov counts, each field within max(TOL_SLICE, RCB_WITNESS_FACTOR x
    its witness spread); its split, ghosts, bytes per exchange, peak
    memory and per-rank launches (K4 staged, K5 staged, K7 halo, K8 and K9
    segment sums > 0; their plain twins, the whole-matrix K7 and the
    column K4 / K5 never); (c) each rank's part kernels against their
    plain twins, timed on rank 0 with bounds and library calls; (d) the
    melt pool on a box-12 gather RCB on 2 ranks, as (a); (e) app.main
    --devices 2 --mesh on a shuffled box's file (no lattice metadata: the
    RCB mode) against a one-process card gather step; (f) the Krylov
    options on the parts (phase_rcb_options)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.main import RunFiles
    from dedflow_tpu_torch.app.scenarios import (
        melt_pool_scenario_config,
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh, shuffled_mesh
    from dedflow_tpu_torch.parallel import launch
    from dedflow_tpu_torch.solver.newton import NSSolver

    out = {"backend": launch.backend_for(RCB_MAIN_RANKS, "cuda")}
    t0 = time.perf_counter()
    res = launch.spawn(rcb_main_rank, RCB_MAIN_RANKS, "cuda", args=(raw,), timeout=600)[0]
    out["main_call_s"] = time.perf_counter() - t0
    # (a) and (d) against the CPU float64 one-process step and a one-process
    # card step (float32, the same kernels) on the same input
    slices = {"delaunay": (rcb_slice_mesh(), rcb_config()),
              "melt": (box_mesh(*RCB_MELT_BOX), melt_pool_scenario_config(use_lattice="gather"))}
    for name, (mesh, cfg) in slices.items():
        tag = "a" if name == "delaunay" else "d"
        refs = {}
        one = NSSolver(mesh, cfg, device="cuda")
        cards = rcb_slice_inputs(mesh, cfg, "cuda", one.dtype)
        for key, (state, src) in rcb_slice_inputs(mesh, cfg, "cpu", torch.float64).items():
            *ref, rstats = NSSolver(mesh, cfg, device="cpu").step(*state, source=src)
            # float32's own distance from the float64 step: a plain float32
            # CPU step on the same input (500 random points leave slivers,
            # and from perturbed_state the pressure rate's float32 step lands
            # 2e-3 from float64 there)
            state32, src32 = rcb_slice_inputs(mesh, cfg, "cpu", torch.float32)[key]
            f32 = NSSolver(mesh, cfg, device="cpu", dtype=torch.float32)
            f32_rel = max(rel_err(g, r)[1]
                          for g, r in zip(f32.step(*state32, source=src32)[:3], ref))
            bar = max(TOL_SLICE, RCB_F32_FACTOR * f32_rel)
            *card1, cstats = one.step(*cards[key][0], source=cards[key][1])
            refs[key] = (ref, rstats, [t.cpu() for t in card1], cstats, bar)
            say(f"  ({tag}) {name} {key}: a plain float32 CPU step vs the float64 one "
                f"rel={f32_rel:.3e}; the bar max(TOL_SLICE, {RCB_F32_FACTOR} x that) = {bar:.3e}; "
                f"the one-process card step: newton {len(cstats.rnorms)}, krylov "
                f"{cstats.krylov_iters}")
        del one, cards
        worlds = RCB_SLICE_RANKS if name == "delaunay" else (RCB_MAIN_RANKS,)
        for world in worlds:
            t0 = time.perf_counter()
            if world == RCB_MAIN_RANKS:
                runs = res["slice" if name == "delaunay" else "melt"]
            else:
                runs = launch.spawn(rcb_slice_rank, world, "cuda", timeout=300)[0]
            where = ("in (b)'s process group" if world == RCB_MAIN_RANKS
                     else f"{time.perf_counter() - t0:.1f} s")
            for key, got in runs.items():
                ref, rstats, card1, cstats, bar = refs[key]
                worst = max(rel_err(torch.as_tensor(g), r)[1] for g, r in zip(got["state"], ref))
                twin = max(rel_err(torch.as_tensor(g), r)[1]
                           for g, r in zip(got["state"], card1))
                say(f"  ({tag}) {name} {key} ({mesh.num_tet} tets) on {world} ranks ({where}): "
                    f"state vs CPU f64 rel={worst:.3e}, vs the one-process card step "
                    f"rel={twin:.3e} (per field {fmt_list(field_errs(got['state'], card1))}); "
                    f"newton {got['newton']} (CPU {len(rstats.rnorms)}, card "
                    f"{len(cstats.rnorms)}), krylov {got['krylov']} (CPU {rstats.krylov_iters}, "
                    f"card {cstats.krylov_iters})")
                check(f"rcb {name} {key} {world} ranks", worst, bar)
                check(f"rcb {name} {key} {world} ranks vs one process", twin, bar)
                if not got["newton"] == len(rstats.rnorms) == len(cstats.rnorms):
                    raise PhaseError(f"rcb {name} {key} {world} ranks: Newton counts "
                                     f"{got['newton']} vs {len(rstats.rnorms)} (CPU), "
                                     f"{len(cstats.rnorms)} (card)")
                if got["krylov"] != rstats.krylov_iters:
                    own, n = krylov_witness(
                        f"rcb {name} {key} {world}", mesh, cfg, got["krylov"],
                        rstats.krylov_iters,
                        lambda m, c, d, t, k=key: rcb_slice_inputs(m, c, d, t)[k])
                    say(f"    krylov counts witnessed by plain float32 CPU steps ({n} runs, "
                        f"own {own})")
                out[f"{name}_{key}_{world}_rel"] = worst
                out[f"{name}_{key}_{world}_vs_one_process"] = twin
    # (b) the full Delaunay mesh on 2 ranks against phase 14's one-process
    # step from the same perturbed state
    ranks = res["ranks"]
    for r in ranks:
        say(f"  (b) rank {r['rank']}: {r['n_own']} own nodes, {r['n_ghost']} ghosts (sent to "
            f"each peer: {r['peers']}), {r['elements']} elements, {r['entries']} entries, "
            f"set-up {r['setup_s']:.2f} s, launches K4s/K5s/K7halo/K8sum/K9sum {r['launches']}, "
            f"whole-matrix K7 / column K4 / K5 {r['absent']}, plain twins called "
            f"{r['plain_calls']}, peak {r['peak_bytes'] / 2**30:.3f} GiB")
        say(f"    step: {json.dumps(r['step'])}")
        if min(r["launches"]) <= 0 or any(r["plain_calls"]) or any(r["absent"]):
            raise PhaseError(f"rcb main: rank {r['rank']} launches {r['launches']}, absent "
                             f"{r['absent']}, plain calls {r['plain_calls']}")
    one = ga_main["perturbed"]
    ops = {k: field_errs([res["operator"][k]], [one["operator"][k]]) for k in one["operator"]}
    say(f"  (b) {raw.num_tet} tets on {RCB_MAIN_RANKS} ranks vs phase 14's one process at "
        f"perturbed_flow_state, per field: "
        + "; ".join(f"{k} {fmt_list(v)}" for k, v in ops.items()))
    for k, v in ops.items():
        check(f"rcb main {k}, every field", max(v), TOL_SLICE)
    fields = field_errs(res["state"], one["state"])
    scales = [float(a[:, c].abs().max()) for a in one["state"] for c in range(a.shape[1])]
    bars = [max(TOL_SLICE, RCB_WITNESS_FACTOR * w) for w in one["spread"]]
    say(f"  (b) the step vs phase 14's one-process step, per field (wgold, dwgold, dwg x 6 "
        f"components) {fmt_list(fields)} of scales {fmt_list(scales)}; the one-process "
        f"witnesses' largest distances {fmt_list(one['spread'])}; newton {res['newton']} (one "
        f"process {one['newton']}), krylov {res['krylov']} (one process {one['krylov']})")
    check("rcb main step, every field over its bar", max(f / b for f, b in zip(fields, bars)), 1.0)
    if res["newton"] != one["newton"] or res["krylov"] != one["krylov"]:
        raise PhaseError(f"rcb main: Newton / Krylov counts {res['newton']} {res['krylov']} vs "
                         f"one process {one['newton']} {one['krylov']}")
    kms = [row["ms"] for row in res["kernels"]]
    steps = [r["step"] for r in ranks]
    split = {
        "wall_s": max(s["wall_s"] for s in steps),
        "kernels_s_est": max(sum(m * n for m, n in zip(kms, r["launches"])) for r in ranks) / 1e3,
        "halo_exchange_s": max(s["exchange_s"] for s in steps),
        "allreduce_s": max(s["allreduce_s"] for s in steps),
        "staging_wait_s": max(s["stage_s"] for s in steps),
        "exchanges": steps[0]["exchanges"], "allreduces": steps[0]["allreduces"],
        "bytes_per_exchange": max(s["sent_bytes"] / max(s["exchanges"], 1) for s in steps),
        "allreduces_per_krylov_iter": steps[0]["allreduces"] / max(sum(steps[0]["krylov"]), 1),
        "ghosts": [r["n_ghost"] for r in ranks], "own": [r["n_own"] for r in ranks],
    }
    split["other_s"] = (split["wall_s"] - split["kernels_s_est"] - split["halo_exchange_s"]
                        - split["allreduce_s"])
    say(f"  (b) split: {json.dumps(split)}")
    out.update(main_operator_rel={k: max(v) for k, v in ops.items()}, main_field_rel=fields,
               main_field_scale=scales, main_witness_spread=one["spread"],
               main_newton=res["newton"], main_krylov=res["krylov"],
               main_split=split, one_process_step_s=one["step_s"],
               peak_gib=[r["peak_bytes"] / 2**30 for r in ranks],
               setup_s=[r["setup_s"] for r in ranks])
    # (e) the CLI's --devices 2 on a mesh file
    t0 = time.perf_counter()
    cmesh = shuffled_mesh(box_mesh(*RCB_CLI_BOX), seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "mesh.npz")
        npz_write_mesh(mpath, cmesh)
        files = RunFiles(read_mesh=npz_read_mesh, write_solution=npz_write_solution,
                         needs_h5py=False)
        rc, _ = cli(["--mesh", mpath, "--no-lattice-recover", "--steps", "1", "--save-every",
                     "1", "--devices", "2", "--out", tmp, "--log-level", "warning"], files)
        snap = dict(np.load(os.path.join(tmp, "sol.1.h5.npz")))
        recs = [json.loads(ln) for ln in open(os.path.join(tmp, "metrics.jsonl"))]
    one = NSSolver(cmesh, reference_scenario_config(use_lattice="gather"), device="cuda")
    wg1 = one.step(*state_from_numpy(*reference_initial_state(cmesh), "cuda", one.dtype))[0]
    crel = rel_err(torch.as_tensor(snap["u"]).reshape(-1, 3), wg1[:, :3].cpu())[1]
    say(f"  (e) app.main --devices 2 --mesh (box {RCB_CLI_BOX} shuffled, {cmesh.num_tet} tets, "
        f"no lattice recovery) ({time.perf_counter() - t0:.1f} s): rc {rc}, metrics {recs}, "
        f"sol.1 u vs a one-process card gather step rel={crel:.3e}")
    if rc != 0 or not recs or recs[0].get("ranks") != 2:
        raise PhaseError(f"app.main --devices 2 --mesh: rc {rc}, metrics {recs}")
    check("app.main --devices 2 --mesh", crel, TOL_SLICE)
    out["cli_rel"] = crel
    t0 = time.perf_counter()
    out["options"] = phase_rcb_options()
    say(f"  (f): {time.perf_counter() - t0:.1f} s")
    launches = [sum(r["launches"][i] for r in ranks) for i in range(len(RCB_KERNELS))]
    return [dict(row, launches=n) for row, n in zip(res["kernels"], launches)], out


# ---------------------------------------------------------------------------
# Phase 27: the coupled FEM-DEM step on ranks (ROADMAP A16 (c)): the fluid on
# z-slabs, each particle's drag computed by one rank, the DEM on cell slabs
# of the flat cell axis through K11's halo entry.

COUPLED_SHARDED_RANKS = 2
COUPLED_CLI_PARTICLES = RUN_PARTICLES  # the coupled CLI run at SLICE_BOX, as phase 21's
COUPLED_SHARDED_KERNELS = (
    ("K11 dem contact sweep (halo entry, cell slab of 2 ranks)",
     "dedflow_tpu_torch/csrc/dem_contact.cu", "dedflow_tpu/dem/grid.py:294"),
)


def npz_write_particles(path, group, state):
    """The CLI's particle group as an .npz of dem.particles.particle_datasets
    (no h5py on the card machine; the ranks write from their own process)."""
    import numpy as np

    from dedflow_tpu_torch.dem.particles import particle_datasets

    np.savez(f"{path}.{group}.npz", **particle_datasets(state))


def window_live_pairs(grid, win, nloc: int) -> tuple[int, int]:
    """(live slots of the window, live pair slots of its centres): the
    (centre, neighbour) slot pairs with both slots occupied, itself
    included, for the centres [omax, omax + nloc) (live_pairs' count on a
    window)."""
    from dedflow_tpu_torch.dem.grid import _offsets, halo_width

    occ = win.mask.sum(0).double()
    omax = halo_width(grid)
    ctr = occ[omax : omax + nloc]
    pairs = sum(float((ctr * occ[omax + o : omax + o + nloc]).sum()) for o in _offsets(grid))
    return int(occ.sum()), int(pairs)


def coupled_sharded_rank(device):
    """A rank of phase 27: CoupledSolver(box 55, coupled_scenario_setup(mesh,
    COUPLED_PARTICLES), sharded=True) one adaptive step from the reference
    initial state (phase 11's first), after one drag exchange and one DEM
    window as a warm-up, the launch counts of K1, K2, K3's
    banded entry, K11's halo entry and the whole-grid K11 set to 0 just
    before and read just after (the plain twins counted: they must not
    run), the drag / fluid / DEM split, the fluid's and the DEM's
    exchanges and all-reduces, peak memory; the gathered state and the
    particles. Then K11's halo entry on this rank's window of the initial
    particles against its plain twin (bit for bit), timed on rank 0 with
    its bound. Rank 0 returns everything."""
    import torch
    import torch.distributed as dist

    from dedflow_tpu_torch.app.coupled import CoupledSolver
    from dedflow_tpu_torch.app.scenarios import (
        coupled_scenario_setup,
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.dem import grid as dg
    from dedflow_tpu_torch.fem import lattice as lat
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.sparse import dia_kernels as dk
    from dedflow_tpu_torch.tools.timing import nbytes

    rank = dist.get_rank()
    t0 = time.perf_counter()
    mesh = box_mesh(*FULL_BOX)
    ccfg, pst0 = coupled_scenario_setup(mesh, num_particles=COUPLED_PARTICLES, device=device)
    solver = CoupledSolver(mesh, reference_scenario_config(), ccfg, device=device, sharded=True)
    fluid, dem_comm = solver.fluid, solver.dem_comm
    state = [fluid.shard_state(a) for a in reference_initial_state(mesh)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # one drag exchange and one DEM window first (both ranks): the timed
    # step's split then holds no first call's library loads and allocations
    solver.advance_particles(pst0, solver.drag(state[0], pst0)[0])
    counters = (lat.residual_volume, lat.jacobian_volume, dk.dia_matvec_banded,
                dg.halo_pair_forces_cuda, dg.grid_pair_forces_cuda)
    plains = ((lat, "residual_volume_plain"), (lat, "jacobian_volume_plain"),
              (dk, "dia_matvec_banded_plain"), (dg, "halo_pair_forces"),
              (dg, "grid_pair_forces"))
    plain_calls = [[0] for _ in plains]
    originals = [getattr(m, n) for m, n in plains]
    for (m, n), f, calls in zip(plains, originals, plain_calls):
        setattr(m, n, _counting(f, calls))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    for comm in (fluid.comm, dem_comm):
        comm.stats.reset()
    dg.dem_run_grid.windows.update(slabs=0, replicated=0)
    dist.barrier()
    torch.cuda.synchronize()
    parts = {}
    t1 = time.perf_counter()
    *new, pst1, stats = solver.step(*state, pst0, timings=parts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = [c.launches for c in counters]
    for (m, n), f in zip(plains, originals):
        setattr(m, n, f)
    comm_rec = lambda st: {"exchanges": st.exchanges, "sent_bytes": st.sent_bytes,
                           "exchange_s": st.exchange_s, "allreduces": st.allreduces,
                           "allreduce_s": st.allreduce_s, "stage_s": st.stage_s}
    rec = {"rank": rank, "setup_s": setup_s, "wall_s": wall, **parts,
           "newton": len(stats.rnorms), "krylov": stats.krylov_iters,
           "fluid_comm": comm_rec(fluid.comm.stats), "dem_comm": comm_rec(dem_comm.stats),
           "windows": dict(dg.dem_run_grid.windows), "launches": launches,
           "plain_calls": [c[0] for c in plain_calls],
           "peak_bytes": torch.cuda.max_memory_allocated()}
    full = [fluid.gather_state(t) for t in new]

    # K11's halo entry on this rank's window of the initial particles
    grid, prm, p = ccfg.dem.grid, ccfg.dem.contact, pst0.num_particle
    world = dem_comm.world
    nloc = -(-grid.num_cell // world)
    own = dg._own_slab(dg.to_grid(grid, pst0, p), rank * nloc, (rank + 1) * nloc, p)
    omax = dg.halo_width(grid)
    static = dg._window(dem_comm, torch.stack([own.radius, own.mask]), omax)
    moving = dg._window(dem_comm, torch.stack([*own.pos, *own.vel]), omax)
    win = dg.GridState(pos=tuple(moving[:3]), vel=tuple(moving[3:]), radius=static[0],
                       mask=static[1], pid=dg._window(dem_comm, own.pid, omax))
    label = f"rank {rank} K11 halo entry"
    kernel = lambda: torch.stack(dg.halo_pair_forces_cuda(grid, win, nloc, prm))
    plain = lambda: torch.stack(dg.halo_pair_forces(grid, win, nloc, prm))
    err = compare(label, kernel, plain, TOL_K11)
    rows = None
    dist.barrier()
    if rank == 0:  # the other rank waits: one process on the card while it is timed
        k, ncw = win.mask.shape
        live, pairs = window_live_pairs(grid, win, nloc)
        dense_pairs = 27 * k * k * nloc
        dense_ops, skipped = op_count(plain)
        # as K11's row: the centres' masks and outputs, the window's masks, the
        # other eight fields of its live slots
        live_bytes = 16 * k * nloc + 4 * k * (ncw - nloc) + 32 * live
        rows = [finish(COUPLED_SHARDED_KERNELS[0][0], {"max_abs_err": err}, kernel, plain, 20,
                       3, live_bytes, (dense_ops * pairs / dense_pairs, skipped))]
        say(f"  {label}: K={k} window {ncw} columns ({nloc} own), live slots {live}, live pair "
            f"slots {pairs} of {dense_pairs}; window bytes {nbytes(win.mask) * 9 / 1e6:.1f} MB")
    dist.barrier()
    recs = [None] * world if rank == 0 else None
    dist.gather_object(rec, recs, dst=0)
    if rank == 0:
        return {"ranks": recs, "state": full, "x": pst1.x.cpu(), "v": pst1.v.cpu(),
                "kernels": rows}


def phase_coupled_sharded(co_main: dict) -> tuple[list, dict]:
    """Phase 27: (a) the coupled main path of phase 11 (box 55, 100,000
    particles) on 2 gloo ranks sharing the card, one adaptive step from
    the reference initial state against phase 11's first: the particles
    bit for bit, each fluid field within TOL_SLICE, equal Newton counts;
    each rank's launches of K1, K2, K3's banded entry and K11's halo entry
    (> 0; the whole-grid K11 and every plain twin never), the drag / fluid
    / DEM split, band exchanges and bytes, all-reduces, peak memory; (b)
    K11's halo entry on each rank's window against its plain twin, timed
    with its bound (one kernel row); (c) app.main --scenario coupled
    --devices 2 at box 12 against a one-process card CoupledSolver step
    (particles.1 bit for bit, sol.1 within TOL_SLICE)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from dedflow_tpu_torch.app.coupled import CoupledSolver
    from dedflow_tpu_torch.app.main import RunFiles
    from dedflow_tpu_torch.app.scenarios import (
        coupled_scenario_setup,
        reference_initial_state,
        reference_scenario_config,
    )
    from dedflow_tpu_torch.interop import state_from_numpy
    from dedflow_tpu_torch.mesh.gen import box_mesh
    from dedflow_tpu_torch.parallel import launch

    out = {"backend": launch.backend_for(COUPLED_SHARDED_RANKS, "cuda")}
    t0 = time.perf_counter()
    res = launch.spawn(coupled_sharded_rank, COUPLED_SHARDED_RANKS, "cuda", timeout=600)[0]
    out["main_call_s"] = time.perf_counter() - t0
    ranks = res["ranks"]
    keys = ("setup_s", "wall_s", "drag_s", "fluid_s", "dem_s", "newton", "krylov", "windows",
            "launches", "plain_calls")
    for r in ranks:
        say(f"  (a) rank {r['rank']}: {json.dumps({k: r[k] for k in keys})}; peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB")
        say(f"    fluid exchanges {json.dumps(r['fluid_comm'])}")
        say(f"    DEM band exchanges {json.dumps(r['dem_comm'])}")
        if min(r["launches"][:4]) <= 0 or r["launches"][4] or any(r["plain_calls"]):
            raise PhaseError(f"coupled sharded: rank {r['rank']} launches K1/K2/K3-banded/"
                             f"K11-halo/K11-whole {r['launches']}, plain calls "
                             f"{r['plain_calls']}")
        if r["windows"] != {"slabs": 1, "replicated": 0}:
            raise PhaseError(f"coupled sharded: DEM windows {r['windows']}")
    fx, fv, fstate, fnewton = (co_main["first"][k] for k in ("x", "v", "state", "newton"))
    same_x, same_v = torch.equal(res["x"], fx), torch.equal(res["v"], fv)
    moved = float((fx - co_main["x0"]).abs().max())
    fields = []
    for c in range(6):
        g = np.concatenate([a[:, c] for a in res["state"]])
        rf = np.concatenate([a[:, c].numpy() for a in fstate])
        fields.append(float(np.abs(g - rf).max() / max(np.abs(rf).max(), 1e-300)))
    newton = ranks[0]["newton"]
    say(f"  (a) box {FULL_BOX}, {COUPLED_PARTICLES} particles on {COUPLED_SHARDED_RANKS} ranks "
        f"vs phase 11's first step: particles x / v bit-equal {same_x} / {same_v} (largest "
        f"displacement {moved:.3e}); fluid rel per field {[f'{v:.3e}' for v in fields]}; "
        f"newton {newton} (phase 11 {fnewton})")
    if not (same_x and same_v):
        raise PhaseError("coupled sharded: the particles differ from phase 11's first step")
    check("coupled sharded fluid", max(fields), TOL_SLICE)
    if newton != fnewton:
        raise PhaseError(f"coupled sharded: Newton counts {newton} vs phase 11's {fnewton}")
    split = {k: max(r[k] for r in ranks) for k in ("wall_s", "drag_s", "fluid_s", "dem_s")}
    split.update(
        fluid_exchange_s=max(r["fluid_comm"]["exchange_s"] for r in ranks),
        fluid_allreduce_s=max(r["fluid_comm"]["allreduce_s"] for r in ranks),
        fluid_allreduces=ranks[0]["fluid_comm"]["allreduces"],
        dem_band_exchanges=ranks[0]["dem_comm"]["exchanges"],
        dem_band_bytes=[r["dem_comm"]["sent_bytes"] for r in ranks],
        dem_exchange_s=max(r["dem_comm"]["exchange_s"] for r in ranks),
        dem_allreduces=ranks[0]["dem_comm"]["allreduces"],
        peak_gib=[r["peak_bytes"] / 2**30 for r in ranks],
        one_process_step_s=co_main["step_s"][0], setup_s=[r["setup_s"] for r in ranks])
    say(f"  (a) split: {json.dumps(split)}")
    out.update(fluid_rel=fields, newton=newton, split=split)

    # (c) the CLI on 2 ranks at box 12 against a one-process card step
    t0 = time.perf_counter()
    cmesh = box_mesh(*SLICE_BOX)
    with tempfile.TemporaryDirectory() as tmp:
        files = RunFiles(write_solution=npz_write_solution, save_particles=npz_write_particles,
                         needs_h5py=False)
        rc, lines = cli(["--scenario", "coupled", "--box", *map(str, SLICE_BOX), "--particles",
                         str(COUPLED_CLI_PARTICLES), "--steps", "1", "--save-every", "1",
                         "--devices", "2", "--out", tmp, "--log-level", "warning"], files)
        snap = dict(np.load(os.path.join(tmp, "sol.1.h5.npz")))
        parts = dict(np.load(os.path.join(tmp, "particles.1.h5.ptc.npz")))
        recs = [json.loads(ln) for ln in open(os.path.join(tmp, "metrics.jsonl"))]
    ccfg, pst = coupled_scenario_setup(cmesh, num_particles=COUPLED_CLI_PARTICLES, device="cuda")
    one = CoupledSolver(cmesh, reference_scenario_config(), ccfg, device="cuda")
    wg1, _, _, pst1, _ = one.step(*state_from_numpy(*reference_initial_state(cmesh), "cuda",
                                                    torch.float32), pst)
    crel = rel_err(torch.as_tensor(snap["u"]).reshape(-1, 3), wg1[:, :3].cpu())[1]
    same_p = (np.array_equal(parts["coord"], pst1.x.cpu().numpy().reshape(-1))
              and np.array_equal(parts["vel"], pst1.v.cpu().numpy().reshape(-1)))
    say(f"  (c) app.main --scenario coupled --devices 2 at box {SLICE_BOX}, "
        f"{COUPLED_CLI_PARTICLES} particles ({time.perf_counter() - t0:.1f} s): rc {rc}, "
        f"metrics {recs}, sol.1 u vs a one-process card step rel={crel:.3e}, particles.1 "
        f"bit-equal {same_p}")
    if rc != 0 or not recs or recs[0].get("ranks") != 2 or not same_p:
        raise PhaseError(f"app.main --scenario coupled --devices 2: rc {rc}, metrics {recs}, "
                         f"particles bit-equal {same_p}")
    check("app.main --scenario coupled --devices 2", crel, TOL_SLICE)
    out["cli_rel"] = crel
    launches = sum(r["launches"][3] for r in ranks)
    return [dict(row, launches=launches) for row in res["kernels"]], out


def run() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        from dedflow_tpu_torch.app.coupled import CoupledSolver
        from dedflow_tpu_torch.app.scenarios import (
            coupled_scenario_setup,
            reference_scenario_config,
        )
        from dedflow_tpu_torch.dem.grid import to_grid
        from dedflow_tpu_torch.mesh.gen import box_mesh
        from dedflow_tpu_torch.solver.newton import NSSolver
        from dedflow_tpu_torch.tools.timing import card_line
    except ImportError as e:
        print(f"FAIL: dedflow_tpu_torch not importable ({e})", file=sys.stderr)
        return 1
    phase = "1 card"
    try:
        card = card_line()
        say(f"phase 1 card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
        phase = "2 build"
        phase_build()
        phase = "3 kernels"
        t0 = time.perf_counter()
        solver = NSSolver(box_mesh(*FULL_BOX), reference_scenario_config(), device="cuda")
        say(f"phase 3 kernels at {solver.mesh.num_tet} tets, {solver.mesh.num_node} "
            f"nodes (setup {time.perf_counter() - t0:.1f} s)")
        results, times = phase_kernels(solver)
        say(f"  system: {json.dumps(times)}")
        phase = "4 slice"
        say(f"phase 4 slice at box {SLICE_BOX}")
        phase_slice()
        phase = "5 main"
        say(f"phase 5 main path at box {FULL_BOX}")
        main = phase_main(solver)
        del solver
        phase = "6 irregular kernels"
        solver, setup, raw = irregular_solver()
        say(f"phase 6 irregular kernels at {solver.mesh.num_tet} Delaunay tets, "
            f"{solver.mesh.num_node} nodes, {solver.wctx.win_plan.S} matrix entries, "
            f"fastpath {solver.fastpath} (host setup s: {json.dumps(setup)})")
        ir_results, ir_staged, ir_times = phase_irregular_kernels(solver)
        say(f"  system: {json.dumps(ir_times)}")
        phase = "7 irregular slice"
        say(f"phase 7 irregular slice at the converted box {SLICE_BOX}")
        phase_irregular_slice()
        phase = "8 irregular main"
        say(f"phase 8 irregular main path at {solver.mesh.num_tet} Delaunay tets")
        ir_main = phase_irregular_main(solver)
        # phase 12 runs K10 on them (the geometry waits on the host, out of
        # the device peaks of phases 9-11)
        rcm, rcm_ien_t, rcm_geom = solver.mesh, solver.wctx.ien_t, solver.wctx.res_geom.cpu()
        del solver
        phase = "9 dem"
        mesh = box_mesh(*FULL_BOX)
        ccfg, pstate0 = coupled_scenario_setup(mesh, num_particles=COUPLED_PARTICLES,
                                               device="cuda")
        grid = ccfg.dem.grid
        say(f"phase 9 dem kernel: bench.py's cases, then the coupled grid "
            f"({COUPLED_PARTICLES} particles, radius {float(pstate0.radius[0]):.4e})")
        dem_result = phase_dem((grid, to_grid(grid, pstate0, COUPLED_PARTICLES),
                                ccfg.dem.contact))
        phase = "10 coupled slice"
        say(f"phase 10 coupled slice at box {SLICE_BOX}, {SLICE_PARTICLES} particles")
        phase_coupled_slice()
        phase = "11 coupled main"
        t0 = time.perf_counter()
        csolver = CoupledSolver(mesh, reference_scenario_config(), ccfg, device="cuda")
        say(f"phase 11 coupled main path at box {FULL_BOX}, {COUPLED_PARTICLES} particles, "
            f"{ccfg.substeps} DEM substeps (setup {time.perf_counter() - t0:.1f} s)")
        co_main = phase_coupled_main(csolver, pstate0)
        del csolver, pstate0
        phase = "12 gather kernels"
        gsolver, gsetup = gather_solver(raw)
        say(f"phase 12 gather kernels: K4/K5 at {raw.num_tet} Delaunay tets in generated "
            f"order, {gsolver.gctx.win_plan.S} matrix entries, fastpath {gsolver.fastpath} "
            f"(host setup s: delaunay_s {setup['delaunay_s']:.2f} shared with phase 6, "
            f"solver_s {gsetup:.2f}); K10 at phase 6's RCM mesh")
        (ga_results, ga_staged, ga_res_staged, ga_times, k5_implicit,
         k10_extra, ga_k7) = phase_gather_kernels(gsolver, rcm, rcm_ien_t, rcm_geom)
        say(f"  gather system: {json.dumps(ga_times)}")
        del rcm_ien_t, rcm_geom
        phase = "13 gather slice"
        say(f"phase 13 gather slice at box {SLICE_BOX}")
        phase_gather_slice()
        phase = "14 gather main"
        say(f"phase 14 gather main path at {raw.num_tet} Delaunay tets, generated node order")
        ga_main = phase_gather_main(gsolver)
        ga_main["perturbed"] = gather_perturbed_step(gsolver, raw)
        del gsolver
        phase = "15 melt kernels"
        msolver, msetup = melt_solver()
        say(f"phase 15 melt kernels at box {MELT_BOX}: {msolver.mesh.num_tet} tets, "
            f"{msolver.mesh.num_node} nodes, melt_pool_scenario_config(), fastpath "
            f"{msolver.fastpath} (setup {msetup:.1f} s)")
        melt_results, melt_times = phase_melt_kernels(msolver)
        say(f"  melt system: {json.dumps(melt_times)}")
        phase = "16 melt slice"
        say(f"phase 16 melt slice at box {SLICE_BOX} on the lattice, WinELL and gather tiers")
        slice_launches = phase_melt_slice()
        phase = "17 melt main"
        say(f"phase 17 melt main path at box {MELT_BOX}: {MELT_STEPS[0]} adaptive steps, then "
            f"{MELT_STEPS[1]} step_fixed({MELT_FIXED_NEWTON}), with the laser source")
        melt_main = phase_melt_main(msolver)
        say(f"  melt main: {json.dumps({k: v for k, v in melt_main.items() if k != 'launches'})}")
        del msolver
        phase = "18 probes"
        say(f"phase 18 probes: K12 on an (8, {PROBE_N}) float32 stream, K13 at W = {PROBE_W}")
        t0 = time.perf_counter()
        probes = phase_probes()
        say(f"  probes: {time.perf_counter() - t0:.1f} s")
        phase = "19 krylov"
        say(f"phase 19 krylov options ({card}): box {FULL_BOX} pc {', '.join(PCS)} and "
            f"precision ir; the RCM Delaunay mesh with pc mg (AMG); the unordered one on the "
            f"gather tier with pc simple; box {SLICE_BOX} slices")
        t0 = time.perf_counter()
        krylov_results, krylov = phase_krylov(rcm, raw)
        say(f"  krylov ({card}): {json.dumps(krylov)}")
        say(f"  phase 19: {time.perf_counter() - t0:.1f} s")
        phase = "20 classes"
        say(f"phase 20 classes ({card}): box {FULL_BOX} deformed (classes tier) and shuffled, "
            f"mirrored, recovered (lattice tier, another split); K3 at 27 planes; K2c implicit and "
            f"P1' at box {MELT_BOX}; box {SLICE_BOX} slices")
        t0 = time.perf_counter()
        class_results, classes = phase_classes()
        say(f"  classes ({card}): {json.dumps(classes)}")
        say(f"  phase 20: {time.perf_counter() - t0:.1f} s")
        phase = "21 run"
        say(f"phase 21 run ({card}): the CLI at box {FULL_BOX} (2 steps, snapshots, metrics, "
            f"--profile), --resume 1, the coupled scenario at box {SLICE_BOX}")
        t0 = time.perf_counter()
        run_out = phase_run(main)
        say(f"  run ({card}): {json.dumps(run_out)}")
        say(f"  phase 21: {time.perf_counter() - t0:.1f} s")
        phase = "22 heat"
        say(f"phase 22 heat ({card}): K8 / K9 one-row; Poisson box {HEAT_SLICE_BOX} slice, "
            f"boxes {HEAT_BOXES[0]} and {HEAT_BOXES[1]}, CG and GMRES({HEAT_GMRES_RESTART}) + "
            f"Jacobi")
        t0 = time.perf_counter()
        heat_results, heat = phase_heat()
        say(f"  heat ({card}): {json.dumps(heat)}")
        say(f"  phase 22: {time.perf_counter() - t0:.1f} s")
        phase = "23 mixed"
        say(f"phase 23 mixed ({card}): prism / hex meshes, box {SLICE_BOX} slice and box "
            f"{FULL_BOX} with a hex table over its cubes on the {MIXED_TIER} tier")
        t0 = time.perf_counter()
        mixed_results, mixed = phase_mixed()
        say(f"  mixed ({card}): {json.dumps(mixed)}")
        say(f"  phase 23: {time.perf_counter() - t0:.1f} s")
        phase = "24 checks"
        say(f"phase 24 checks ({card}): residual_check at n = {CHECK_RESIDUAL_BOX}, selfcheck, "
            f"nonlinear_f64_check at box {CHECK_NONLINEAR_BOX}")
        t0 = time.perf_counter()
        checks = phase_checks()
        say(f"  checks ({card}): {json.dumps(checks)}")
        say(f"  phase 24: {time.perf_counter() - t0:.1f} s")
        phase = "25 sharded"
        say(f"phase 25 sharded ({card}): z-slab ranks sharing the card, box {SLICE_BOX} on "
            f"{' and '.join(map(str, SHARDED_SLICE_RANKS))} ranks, box {FULL_BOX} on "
            f"{SHARDED_MAIN_RANKS} (one step), the slab kernels, dryrun_multichip(2), app.main "
            f"--devices 2; (e) pc {', '.join(SHARDED_OPTIONS)} at box {SHARDED_OPTION_BOX}, pc mg "
            f"at box {FULL_BOX}, K3 float64 banded")
        t0 = time.perf_counter()
        sharded_results, sharded = phase_sharded(main, krylov)
        say(f"  sharded ({card}): {json.dumps(sharded)}")
        say(f"  phase 25: {time.perf_counter() - t0:.1f} s")
        phase = "26 rcb"
        say(f"phase 26 rcb ({card}): RCB parts on the gather tier, ranks sharing the card: "
            f"delaunay_mesh({RCB_SLICE_POINTS}) on {' and '.join(map(str, RCB_SLICE_RANKS))} "
            f"ranks, {raw.num_tet} Delaunay tets on {RCB_MAIN_RANKS} (one step), the part "
            f"kernels, the melt pool at box {RCB_MELT_BOX}, app.main --devices 2 --mesh; (f) "
            f"{', '.join(RCB_OPTIONS)} on delaunay_mesh({RCB_SLICE_POINTS})")
        t0 = time.perf_counter()
        rcb_results, rcb = phase_rcb(ga_main, raw)
        say(f"  rcb ({card}): {json.dumps(rcb)}")
        say(f"  phase 26: {time.perf_counter() - t0:.1f} s")
        phase = "27 coupled sharded"
        say(f"phase 27 coupled sharded ({card}): box {FULL_BOX} with {COUPLED_PARTICLES} "
            f"particles on {COUPLED_SHARDED_RANKS} ranks sharing the card (one step), K11's halo "
            f"entry, app.main --scenario coupled --devices 2 at box {SLICE_BOX}")
        t0 = time.perf_counter()
        coupled_sharded_results, coupled_sharded = phase_coupled_sharded(co_main)
        say(f"  coupled sharded ({card}): {json.dumps(coupled_sharded)}")
        say(f"  phase 27: {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # report the failed phase, then fail
        traceback.print_exc()
        print(f"FAIL phase {phase}: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    # the melt modes' launches: K1/K2 from the melt main path (phase 17),
    # the implicit Jacobian of K6 (33-row) and K5 from the melt slice's
    # WinELL and gather steps (phase 16), where the scenario runs them: the
    # staged kernels there, the column entries 0
    melt_launches = melt_main["launches"][:2] + [0, 0]
    staged_launches = (ir_main["staged"][:1] + [slice_launches["winell"][2]] + ir_main["staged"][1:]
                       + ga_main["staged"][:1] + [slice_launches["gather"][1]]
                       + ga_main["staged"][1:])
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n, **r}
        for (name, src, rep), r, n in zip(
            KERNELS + IRREGULAR_KERNELS + DEM_KERNELS + GATHER_KERNELS + MELT_KERNELS
            + STAGED_KERNELS + RESIDUAL_STAGED_KERNELS + KRYLOV_KERNELS + CLASS_KERNELS
            + HEAT_KERNELS + MIXED_KERNELS + SHARDED_KERNELS + SHARDED_OPTION_KERNELS
            + RCB_KERNELS + K10_KERNELS
            + COUPLED_SHARDED_KERNELS + GATHER_SPMV_KERNELS,
            results + ir_results + [dem_result] + ga_results + melt_results + [k5_implicit]
            + ir_staged + ga_staged + ga_res_staged + krylov_results + class_results
            + heat_results + mixed_results + sharded_results + rcb_results + k10_extra
            + coupled_sharded_results + [ga_k7],
            main["launches"] + ir_main["launches"] + co_main["launches"][3:]
            + ga_main["launches"][:2]
            + [ir_main["k10_launches"]["residual"], ir_main["k10_launches"]["jacobian"]]
            + ga_main["launches"][3:]
            + melt_launches + staged_launches + ga_main["res_staged"]
            + [r["launches"] for r in krylov_results] + [r["launches"] for r in class_results]
            + [r["launches"] for r in heat_results] + [r["launches"] for r in mixed_results]
            + [r["launches"] for r in sharded_results] + [r["launches"] for r in rcb_results]
            # K10 with the source: its instance's count on the WinELL melt slice
            # (phase 16); the residual map alone runs on no path
            + [slice_launches["winell"][6], 0]
            + [r["launches"] for r in coupled_sharded_results]
            + [ga_main["launches"][2]],
        )
    ]
    # the probes' launches: those of their entry points' runs (phase 18)
    kernels += [{"name": name, "route": "cuda", "source": src, "replaces": rep, **r}
                for name, src, rep, r in probes]
    kernels.sort(key=lambda k: int(k["name"].split()[0][1:]))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
