#!/usr/bin/env python3
"""Drive the PyTorch port's SWAR substrate, serving path, state-constrained
tier, multi-device tier, the other model families, every condensation
form, the host SQP tier, the LTI controllers, the planners, the native host
tier and checkpoints once on one H100.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):

1. device check: a CUDA card of compute capability 9.0, its name and power
   limit from nvidia-smi; TF32 off;
2. build: the kernels under pint_tpu_torch/csrc/ with nvcc, one process a
   source, and meanwhile the native host library with g++; from the
   build's -Xptxas -v report, the registers of every K2,
   K2p, K3, K4, K5, K6, K7, K10 and chain kernel (none may spill) and any
   kernel that spills;
3. substrate: the SWAR kernels K1 (binop), K9 (shift), K8 (saturating
   accumulate) and their u64 pair forms K11a-c, each against its plain
   PyTorch version on 1Mi full-range random words and against the per-lane
   Oracle on 2048 canonical words, on the layouts <8,8,8,8>,
   <1,2,3,4,5,6,11>, <5,6,5> (u16), <3,3> (u8), <8 x 8> (u64) and
   <20,20,24> (u64); bit-identical.  Then a user's PackedArray flow as the
   reference's quickstart writes it, Python lanes and numpy words with no
   device named, every result on the card (pack, add/sub saturate, min/max,
   shifts, get_signed, slice_lanes, lanes, the fused accumulate and the pair
   entries), equal to the same flow with device="cpu";
4. headline (bench.py:_run_headline): raw int32 add, K1
   add_unsigned_saturate on <8,8,8,8> at 16Mi words, raw add again, by CUDA
   events, K1 at no less than 0.9 of the raw add's word rate; the u64
   family at 8Mi <8 x 8> words; K9 and K8 (steps = 4).  Each kernel timed
   here is first held bit-identical to its plain version on the inputs it
   is timed on;
5. kernel checks at the serving shapes, each kernel against its plain
   PyTorch version on the card, with CUDA-event times of both:
   K2 fused PGD on the s8 tensor cores (B = 8192, Tp = 64, 15 and 40
   iterations, momentum off and on; bit-identical), K3 lipq and K4 PGD inner on one real DeviceSQP
   condensation (B = 4096, Tm = 64; K3's hqt, h_max and lip bit-identical;
   K4's lanes entry and its words entry bit-identical to their plain
   versions and to each other, the words entry one kernel launch with no
   unpack or pack, torch.profiler);
6. K6 penalty power iteration and K5 ALM inner on one real
   DeviceConstrainedSQP condensation at the constrained RTI configuration
   (unicycle T = 32, F = [[0,1,0]], lo/hi = -+0.03, rho 100, 3 x 30 ALM,
   B = 4096, Tm = 64, C = 32 rows padded to Cp = 64), each against its
   plain version (K6's sqc, sqj, s_scale bit-identical, pen_lip and row_amp
   rtol 1e-5 with the count of problems differing in bits; K5's words and
   multipliers bit-identical, and against the word-space _alm_batched on
   256 problems);
7. the LTI constrained solve (bench_constrained: double integrator T = 50,
   velocity corridor -+0.25, rho 50, ConstrainedPGD 12 x 60, B = 4096)
   through ConstrainedPGD.solve on K7, and K7 against its plain version and
   the word-space ConstrainedPGD(fused=False), bit-identical; solves/s;
8. MPCService: LTI double integrator, T = 50 (Tp = 64), batch 8192, 15 PGD
   iterations a tick, 10 ticks;
9. RTIService: unicycle DeviceSQP, T = 32, batch 4096, 1 SQP x 30 PGD a
   tick, 10 ticks: the chain kernel, K3 and K4 once a tick, K4 on the
   packed words with no unpack or pack around it;
10. ConstrainedRTIService at phase 6's configuration, 1 SQP x (3 x 30 ALM)
    a tick, 10 ticks: controls finite and in the box, the chain kernel, K3,
    K6 and K5 once a tick, the multipliers nonzero (the corridor binds);
11. the flagship DeviceSQP solve, 4 SQP x 30 PGD, batch 4096, once through
    the kernels and once through the plain versions, held to cost parity
    (rtol 0.01, atol 1e-4);
12. the constrained flagship, DeviceConstrainedSQP 4 SQP x (3 x 30 ALM) at
    phase 6's configuration, kernels against plain versions: cost parity
    (rtol 0.01, atol 1e-4), violation parity (atol 5e-3), mean cost below
    the cold plan's;
13. K2p (K2's tensor-core loop on the words' bytes):
    FusedPGD(packed_io=True).solve at the LTI serving shape (B = 8192,
    Tp = 64, 15 iterations) equal to packed_io=False, then K2p at 15 and 40
    iterations bit-identical to K2 with its unpack and pack and to its plain
    version, with CUDA-event ms of K2p, K2 alone, K2 with unpack and pack,
    and the plain version;
14. K10 alone on rank 0's slab of one real DeviceSQP lipq condensation and
    one DeviceConstrainedSQP condensation (Tm = 64, Cp = 64, B = 4096) at
    tp = 2 and 4 (K = 32 and 16 columns, rows 64 and 128), bit-identical to
    its plain version, CUDA-event ms of both;
15. the multi-device tier at world size 1 over NCCL (make_mesh(dp=1, tp=1)
    with no device named, on the card): DeviceSQP.sharded_solve_words (4 x
    30, B = 4096) and DeviceConstrainedSQP.sharded_solve_words (4 x (3 x
    30)) bit-identical to solve_words in words and multipliers, ShardedPGD
    (LTI serving, 15 iterations) to FixedPointPGD and FusedPGD,
    ShardedConstrainedPGD (phase 7's configuration) to ConstrainedPGD,
    FusedPGD.dp_sharded to solve_words;
16. a two-rank rehearsal on the one card (dp = 1, tp = 2), two processes of
    this script (``--rehearsal-rank``): NCCL refuses two ranks on one
    device, so gloo carries the collectives of CUDA tensors through the
    host.  The same solves; the ranks' K3 slabs must agree (a checksum
    all-reduced), their joined words and their multipliers must equal
    phase 15's one-process results bit for bit, and K10 must have launched
    on both ranks in both SQP solves.  Each rank then save_sharded's its
    block of the DeviceSQP plan, passes a barrier and load_sharded's the
    rows it holds under ("dp", None); the parent's load_full of the two
    files must equal the one-process words.  Wall ms are the rehearsal's,
    not a rate of the tier;
17. long horizons, 2 SQP iterations each: DeviceSQP and
    DeviceConstrainedSQP at T = 128, B = 4096 (K3 with rows in registers,
    K6's cluster kernel, K4's and K5's cluster kernels), DeviceConstrainedSQP
    at T = 136, B = 1024 (C 136 x Tm 272: K6's cluster kernel, where K6's
    first gate took the torch form), and both at T = 144, B = 1024 (past
    K3's fit: the torch phases, no K6), each against use_kernels=False: 0
    problems differing in words and multipliers, cost parity; then those
    kernels alone on real operands at those shapes, each against its plain
    version;
18. past 256 lanes (phase_wide): FusedPGD (K2, momentum off and on, K2p)
    and ConstrainedPGD (K7) solves at T = 260 through the wide forms, equal
    to the word-space solvers; then K2 (momentum off and on), K2p and K7 at
    Tp = 260, 512 and 2048 (K7 at (Tp, Cp) = (260, 260), (512, 256),
    (512, 512), (2048, 2048), 3 x 10), B = 4096, each bit-identical to its
    plain version and timed, each an entry of the kernels line;
19. rollouts (bench.py's section): DoubleIntegrator.rollout_packed at
    B = 8192, H = 52 from seeded words, bit-identical to the CPU's;
    ``rollouts_per_s_b8192_h52`` by the host clock and the device time;
20. ConstrainedController at tests/test_constrained.py:256's configuration
    on 4096 seeded states for 50 ticks: K7 every tick, bit-identical to
    the CPU's loop, |v| < v_max + 0.01; ticks/s;
21. the planar quadrotor (bench.py's quadrotor_device: T = 16, B = 4096,
    4 x 30 and 4 x (3 x 30)) and the pendulum (T = 32) through DeviceSQP
    and DeviceConstrainedSQP, kernels against use_kernels=False: 0 problems
    differing in bits, cost and violation parity; solves/s and device time;
22. the condensation forms (phase_forms): both flagship solvers, one SQP
    iteration in each propagate and reduce form, at cost parity with
    unroll + sym, with their device times; DeviceSQP's recursion against
    allpairs at T = 8, 16, 24, 32, 40, 64;
23. the host SQP tier (phase_sqp_host): QuantizedSQP (unicycle T = 32,
    6 x 40) and ConstrainedSQP (|y| <= 0.03, rho 100, 6 x (4 x 40)) at
    B = 512, SQPController at B = 256 for 20 ticks, bit-identical to the
    CPU (words, multipliers, cost histories, states, applied lanes; the CPU
    runs every eighth problem); solves/s and ticks/s, one iteration's host
    condensation ms and inner device ms;
24. the LTI controllers on K2 (phase_lti_controllers):
    RecedingHorizonController (double integrator, T = 32, 12 iterations)
    at B = 8192 for 40 ticks, fused (K2 once a tick) = word-space = CPU;
    the quadrotor hover LTIController (T = 40, n 6, m 2, 25 iterations) at
    B = 4096 for 160 ticks, with error feedback against the CPU and fused
    (K2 once a tick) against the word-space loop; the profiler shows one K2
    a tick; ticks/s and device ms a tick;
25. the planners (phase_planners): QuantizedMPPI (H 50, K 512, B 16: 8192
    rollouts an update) plan and 40-tick closed loop, and
    QuantizedNonlinearPGD (H 48, 60 iterations, goal + obstacle) at
    B = 4096, each at cost parity with the CPU (the same noise for MPPI),
    the differing lanes counted; rollouts/s, solves/s, device time;
26. examples/swingup.py's flow (phase_swingup): a pendulum QuantizedSQP
    plan at T = 128 bit-identical to the CPU's, then an SQPController
    tracker (T = 16) for 192 ticks, ending with |theta| < 0.02 turns;
27. the native host tier (phase_native): NativeOps (host C++, built with
    g++) on phase 3's layouts at 1Mi full-range words, every binop and
    shift bit-identical to K1 and K9 on the card (K11a and K11b for u64),
    pack and both unpacks equal to ops/word on the card; its host ms for
    add_unsigned_saturate at the headline's 16Mi words beside K1's queued
    ms, with the card and the host CPU named;
28. checkpoints (phase_checkpoint): save_packed/load_packed of the
    headline's 16Mi words round trip bit-identical; FusedPGD 15 iterations
    against 7 + save_solver_state/load_solver_state + 8 at B = 8192, Tp =
    64, bit-identical, K2 launched in each solve; the flagship DeviceSQP
    (T 32, B 4096, 4 x 30) with fused=False (K3, then the word-space inner)
    bit-identical to fused=None (K3, then K4), K4 launched only by the
    latter;
29. the chain kernel (phase_chain, ``mpc/propagate.py``: the unicycle's
    f32 rollout, linearization and propagator recursion in one launch) at
    the benchmark's shapes, T = 32 at B = 4096 and 16384 and T = 128 at
    B = 4096: Abar, Bbar and Cbar equal (``torch.equal``) to its plain
    version on the card, and timed;
30. the reduce kernel (phase_reduce, ``mpc/reduce.py``: the condensed
    Hessian and linear term from the chain's stacks in one launch) at the
    same shapes: Ht and g equal (int32 bits) to its plain version on the
    card, and timed beside the torch ``_reduce_sym`` it replaces;
31. the stacking kernel (phase_stack, ``mpc/stack.py``: the constraint rows
    S_t, P_t and r_t from the chain's stacks in one launch) at the
    constrained cells' shapes (the unicycle's three and the quadrotor's T =
    16, B = 4096) and one-hot F: equal (int32 bits) to its plain version on
    the card, and timed beside the einsums it replaces.

Launch counts are set to 0 before each main path and read after it: the
PackedArray flow must launch every SWAR kernel, the LTI constrained solve
K7, phases 8-10 every serving kernel, phase 13 K2p, phase 15 K2-K6,
phase 16 K10 on both ranks, phase 17 each long-horizon solve's kernels
(the chain kernel once an SQP iteration of each unicycle solve),
phase 18 the wide forms of K2, K2p and K7, phase 20 K7 once a tick,
phase 21 K3 and K4 (K3, K6 and K5) in each solve, phase 24 K2 once a
tick in both fused LTI loops (K2's launches in the kernels line add the
MPCService ticks and these), phases 9-10 the chain and the reduce kernels
once a tick and phase 10 the stacking kernel, phase 17 each once an SQP
iteration, the stacking in the constrained solves alone, phase 21 the
stacking once an SQP iteration of the quadrotor's constrained solve (the
counts ``propagate.launch_count()``, ``reduce.launch_count()`` and
``stack.launch_count()`` are kept beside ``launch_counts()``), and phase
28 K2 in each resumed solve and K3 (and K4 for fused=None) in each
flagship solve.
The line before the last is the kernels' JSON
record: for each kernel its launches, its error, one call between CUDA events
(``ms``), calls queued behind a device sleep (``queued_ms``), the plain
version, the bound from ``utils.profiling.kernel_cost`` at the timed shape
over the H100's published peaks (``bound_ms``, ``bound_by``,
``share_of_bound`` = bound over queued time) and ``library_ms`` (null: no
single PyTorch call computes these functions; ``library`` says why).  The
last line is ``{"ok": true, "device": {...}}``.  Inputs are made from fixed
seeds.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

import numpy as np

ROOT = Path(__file__).resolve().parent

LTI_BATCH, RTI_BATCH, TICKS = 8192, 4096, 10
DEVICE = "cuda"
SWAR_LAYOUTS = [(8, 8, 8, 8), (1, 2, 3, 4, 5, 6, 11), (5, 6, 5), (3, 3),
                (8,) * 8, (20, 20, 24)]
SHIFT_AMOUNTS = (0, 1, 3, 7, 12, 100, -1)
N_CHECK, N_ORACLE = 1 << 20, 2048
N_HEADLINE, N_U64, ACCUM_STEPS = 1 << 24, 1 << 23, 4
SPEED_OF_LIGHT_MIN = 0.9      # K1's word rate over the raw int32 add's
NO_SPILL_SOURCES = ("fused_pgd.cu", "lipq.cu", "pgd_hqt.cu", "alm.cu",  # operands in
                    "pen.cu", "matvec_cols.cu",                # registers: K2-K7, K10
                    "propagate.cu", "stack.cu")                # the chain, the stacking
SQP_KW = dict(
    horizon=32, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


CON_BATCH = 4096
CON_SQP_KW = dict(horizon=32, pgd_iters=30, x_ref=np.array([1.0, 0.0, 0.0]))
CON_KW = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3)
LTI_CON_T, LTI_CON_OUTER, LTI_CON_INNERS = 50, 12, 60
LONG_T, LONG_BATCH, LONG_SQP = 128, 4096, 2
K4_WIDEST = 632              # pgd_viable's widest horizon (phase_long_kernels)
PEN_T, PEN_BATCH = 136, 1024      # C = Tm / 2 = 136: past K6's first gate (C, Tm <= 256)
PAST_T, PAST_BATCH = 144, 1024    # past K3's fit, so (as in the reference) no K6
# a 2-row constraint (the lateral offset, and the position along x) at T =
# 20: C = Tm = 40, K6's warp kernel (32 < C <= 64)
TWO_ROW_T, TWO_ROW_BATCH = 20, 4096
CON2_KW = dict(F=[[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], lo=[-0.03, -0.5], hi=[0.03, 1.5],
               rho=100.0, alm_outer=3)
# past 256 lanes: K2 and K2p at 15 iterations (the LTI serving tick's), K7 at
# 3 x 10 (its 12 x 60 would take seconds a call at 2048 x 2048)
WIDE_BATCH, WIDE_ITERS, WIDE_TP = 4096, 15, (260, 512, 2048)
WIDE_K7 = ((260, 260), (512, 256), (512, 512), (2048, 2048))
WIDE_K7_OUTER, WIDE_K7_INNERS = 3, 10
ROLL_BATCH, ROLL_H = 8192, 52                   # bench.py's rollouts section
CTRL_BATCH, CTRL_TICKS, CTRL_T, CTRL_VMAX = 4096, 50, 32, 0.15
MODEL_BATCH = 4096
QUAD_KW = dict(horizon=16, sqp_iters=4, pgd_iters=30,     # bench.py's quadrotor_device
               Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]), R=np.diag([0.05, 0.05]),
               qf_scale=20.0, x_ref=np.zeros(6))
QUAD_CON = dict(F=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]], lo=-0.15, hi=0.15, rho=50.0,
                alm_outer=3)
PEND_KW = dict(horizon=32, sqp_iters=4, pgd_iters=20, Q=np.diag([1.0, 0.05]),
               R=np.array([[0.05]]), x_ref=np.zeros(2))
PEND_CON = dict(F=[[0.0, 1.0]], lo=-0.4, hi=0.4, rho=50.0, alm_outer=3)
FORMS_T = (8, 16, 24, 32, 40, 64)
# phase 23, the host SQP tier: tests/test_ltv.py:99's planner and
# tests/test_sqp_constrained.py's binding corridor.  The host condensation
# (numpy einsums, one thread) bounds the batch; the card runs every problem
# and the CPU checks every SQP_CHECK_STRIDE-th (each problem's words are
# independent of its batch companions)
SQP_HOST_KW = dict(SQP_KW, sqp_iters=6, pgd_iters=40)
CSQP_KW = dict(horizon=32, sqp_iters=6, pgd_iters=40, x_ref=np.array([1.0, 0.0, 0.0]))
CSQP_CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=4)
SQP_HOST_BATCH, SQP_CHECK_STRIDE = 512, 8
SQPC_BATCH, SQPC_TICKS = 256, 20
# phase 24, the LTI controllers on K2: tests/test_controller.py's double
# integrator and tests/test_quadrotor.py:56's hover loop
RHC_BATCH, RHC_TICKS, RHC_T, RHC_ITERS = 8192, 40, 32, 12
HOVER_BATCH, HOVER_TICKS, HOVER_T, HOVER_ITERS, HOVER_CHECK_STRIDE = 4096, 160, 40, 25, 32
# phase 25, the planners: BASELINE's 8192 rollouts of H = 50 an MPPI update
# (B 16 x K 512), tests/test_nonlinear.py's planner at B 4096
MPPI_BATCH, MPPI_H, MPPI_K, MPPI_UPDATES, MPPI_TICKS = 16, 50, 512, 8, 40
NL_BATCH, NL_H, NL_ITERS, NL_CHECK_STRIDE, NL_PROFILE_ITERS = 4096, 48, 60, 16, 5
# phase 26, examples/swingup.py's flow
SWING_TICKS = 192


def say(*parts):
    print(*parts, flush=True)


def pct(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), card has {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def ptxas_kernels(report):
    """(source, kernel, registers, spill store bytes, spill load bytes) of
    every kernel in the build's ``-Xptxas -v`` report."""
    rows, src, fn, spill = [], None, None, (0, 0)
    for line in report.splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif "Function properties for" in line:
            fn, spill = line.split("Function properties for", 1)[1].strip(), (0, 0)
        elif (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spill = (int(m[1]), int(m[2]))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            rows.append((src, fn, int(m[1]), *spill))
            fn = None
    return rows


def phase_build(K):
    import threading

    from pint_tpu_torch import native

    # the native host library (phase 27) compiles with g++ meanwhile
    host = {}
    thread = threading.Thread(target=lambda: host.update(ok=native.native_available()))
    t0 = time.perf_counter()
    thread.start()
    so = K.build()
    K.library()
    sec = time.perf_counter() - t0
    thread.join()
    both = time.perf_counter() - t0
    rows = ptxas_kernels(so.with_suffix(".ptxas.txt").read_text())
    say(f"build: {so.name} in {sec:.2f} s; ptxas: {len(rows)} kernels; native host "
        f"library {'built' if host.get('ok') else 'FAILED'}, both done in {both:.2f} s")
    shown = [r for r in rows if r[0] in NO_SPILL_SOURCES or r[3] or r[4]]
    for src, fn, regs, st, ld in shown:
        say(f"  ptxas {src} {fn}: {regs} registers, {st} bytes spill stores, "
            f"{ld} bytes spill loads")
    spilled = [r for r in shown if r[0] in NO_SPILL_SOURCES and (r[3] or r[4])]
    if spilled:
        raise AssertionError(f"ptxas: {len(spilled)} kernels of {NO_SPILL_SOURCES} spill "
                             f"registers: {spilled}")
    return {f"{src} {fn}": dict(registers=regs, spill_stores=st, spill_loads=ld)
            for src, fn, regs, st, ld in shown}


def rand_words(torch, W, lay, shape, seed):
    """Full-range random words in the layout's container, on the card."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    info = torch.iinfo(W.container_dtype(lay))
    high = info.max + 1 if info.bits < 64 else info.max   # randint's high is int64
    w = torch.randint(info.min, high, shape, generator=g, dtype=torch.int64,
                      device=DEVICE)
    return w.to(W.container_dtype(lay))


def same(torch, what, got, ref):
    """Raises unless ``got`` equals ``ref`` bit for bit."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.equal(got, ref):
        bad = int((got != ref).sum()) if got.shape == ref.shape else "shape"
        raise AssertionError(f"{what}: kernel differs from its reference ({bad})")


def phase_substrate(torch, P):
    """Every SWAR kernel against its plain version (1Mi full-range words)
    and against the Oracle (canonical words), on every listed layout."""
    from pint_tpu_torch.convert import words_to_numpy
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.ops.split64 import merge_u64, split_u64
    from pint_tpu_torch.utils import Oracle

    checked = dict.fromkeys(P.ops.kernels.SWAR_KERNELS, 0)

    def held(name, what, got, ref):
        same(torch, f"{name} {what}", got, ref)
        checked[name] += 1

    def u64(t):
        return words_to_numpy(t).astype(np.uint64)

    for seed, widths in enumerate(SWAR_LAYOUTS):
        lay = P.PackedLayout(*widths)
        ora = Oracle(lay)
        wide = lay.word_bits == 64
        a = rand_words(torch, W, lay, (N_CHECK,), 10 * seed)
        b = rand_words(torch, W, lay, (N_CHECK,), 10 * seed + 1)
        d = rand_words(torch, W, lay, (ACCUM_STEPS, N_CHECK), 10 * seed + 2)
        used = W._k(lay, lay.used_mask)
        ca, cb, cd = a[:N_ORACLE] & used, b[:N_ORACLE] & used, d[:, :N_ORACLE] & used
        na, nb = u64(ca), u64(cb)
        for op in S.BINOP_NAMES:
            got = S.binop(lay, op)(a, b)
            held("swar_binop", f"{op} {widths}", got, S.binop_plain(lay, op, a, b))
            exp = getattr(ora, op)(na, nb)
            if not np.array_equal(u64(S.binop(lay, op)(ca, cb)), exp):
                raise AssertionError(f"swar_binop {op} {widths}: differs from Oracle")
            if wide:
                pa, pb = split_u64(a), split_u64(b)
                held("swar_binop_pair", f"{op} {widths}", S.binop_pair(lay, op)(pa, pb),
                     S.binop_plain(lay, op, pa, pb, pair=True))
                held("swar_binop_pair", f"{op} {widths} vs native",
                     merge_u64(S.binop_pair(lay, op)(pa, pb)), got)
        for op in S.SHIFT_NAMES:
            for amt in SHIFT_AMOUNTS:
                got = S.shift(lay, op)(a, amt)
                held("swar_shift", f"{op}({amt}) {widths}", got,
                     S.shift_plain(lay, op, a, amt))
                held("swar_shift", f"{op}(card amount {amt}) {widths}",
                     S.shift(lay, op)(a, torch.tensor(amt, device=DEVICE)), got)
                exp = getattr(ora, op)(na, amt & 0xFFFFFFFF)
                if not np.array_equal(u64(S.shift(lay, op)(ca, amt)), exp):
                    raise AssertionError(f"swar_shift {op}({amt}) {widths}: "
                                         "differs from Oracle")
                if wide:
                    pa = split_u64(a)
                    held("swar_shift_pair", f"{op}({amt}) {widths}",
                         S.shift_pair(lay, op)(pa, amt),
                         S.shift_plain(lay, op, pa, amt, pair=True))
        for signed in (False, True):
            fn = S.saturating_accumulate(lay, signed=signed, steps=ACCUM_STEPS)
            got = fn(a, d)
            held("swar_sat_accum", f"signed={signed} {widths}", got,
                 S.sat_accum_plain(lay, signed, a, d))
            f = ora.add_signed_saturate if signed else ora.add_unsigned_saturate
            exp = na
            for s in range(ACCUM_STEPS):
                exp = f(exp, u64(cd[s]))
            if not np.array_equal(u64(fn(ca, cd)), exp):
                raise AssertionError(f"swar_sat_accum signed={signed} {widths}: "
                                     "differs from Oracle")
            if wide:
                pa, pd = split_u64(a), split_u64(d)
                held("swar_sat_accum_pair", f"signed={signed} {widths}", fn(pa, pd),
                     S.sat_accum_plain(lay, signed, pa, pd))
                held("swar_sat_accum_pair", f"signed={signed} {widths} vs native",
                     merge_u64(fn(pa, pd)), got)
        say(f"substrate {widths} u{lay.word_bits}: 10 binops, 2 shifts x "
            f"{len(SHIFT_AMOUNTS)} amounts, accumulate x2"
            f"{', and their pair forms' if wide else ''}: bit-identical to the "
            f"plain versions ({N_CHECK} words) and the Oracle ({N_ORACLE})")
    say("substrate checks: " + ", ".join(f"{k} {v}" for k, v in checked.items()))


def packed_flow(torch, P, device=None):
    """What a user of the library does (examples/quickstart.py:18-35), as
    the reference writes it: Python lanes and numpy words with no device
    named, which land on the card.  ``device="cpu"`` runs it on the host.
    Returns every result on the host and the set of devices they lived on."""
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops.split64 import merge_u64, split_u64

    on = {} if device is None else {"device": device}
    out = {}
    lay = P.PackedLayout(5, 6, 5)
    a = P.PackedArray.pack(lay, 1, 20, 10, **on)
    b = P.PackedArray.pack(lay, 30, 60, 20, **on)
    out["wrap"] = P.add_wrap(a, b).lanes()
    out["sat_u"] = P.add_unsigned_saturate(a, b).lanes()
    out["min_u"] = P.min_unsigned(a, b).lanes()
    out["shl2"] = P.shift_left(a, 2).lanes()
    words = np.arange(1 << 16, dtype=np.uint32) * np.uint32(40503)
    x = P.PackedArray.from_words(P.PackedLayout(8, 8, 8, 8), words, **on)
    y = P.add_signed_saturate(x, x)
    z = P.max_signed(P.sub_signed_saturate(y, x), P.min_unsigned(x, y))
    z = P.shift_right_unsigned(z, torch.tensor(3, device=x.device))
    z = P.sub_unsigned_saturate(P.add_wrap(z, x), P.sub_wrap(x, y))
    out["get_signed"] = P.get_signed(z, 3)
    out["slice"] = P.slice_lanes(z, 1, 3).lanes()
    deltas = torch.stack([y.word, z.word, x.word, y.word])
    acc = S.saturating_accumulate(x.layout, signed=True, steps=4)(z.word, deltas)
    out["accumulate"] = P.PackedArray(acc, x.layout).lanes_signed()
    lay64 = P.PackedLayout(20, 20, 24)
    w64 = P.PackedArray.from_words(lay64, x.word.to(torch.int64) * 0x9E3779B97F4A7C15)
    v64 = P.shift_left(P.add_signed_saturate(w64, w64), 5)
    p = split_u64(v64.word)
    q = S.binop_pair(lay64, "min_signed")(p, split_u64(w64.word))
    q = S.shift_pair(lay64, "shift_right_unsigned")(q, 7)
    q = S.saturating_accumulate(lay64, signed=False, steps=2)(q, torch.stack([p, q], 1))
    out["u64"] = P.PackedArray(merge_u64(q), lay64).lanes()
    return {k: v.cpu() for k, v in out.items()}, {v.device.type for v in out.values()}


def phase_packed_flow(torch, P, K):
    K.reset_launch_counts()                     # main path starts here
    got, where = packed_flow(torch, P)          # no device named: the card
    torch.cuda.synchronize()
    counts = K.launch_counts()                  # main path ends here
    if where != {"cuda"}:
        raise AssertionError(f"PackedArray flow with no device named ran on {where}")
    for name in K.SWAR_KERNELS:
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the PackedArray flow")
    ref, where = packed_flow(torch, P, "cpu")
    if where != {"cpu"}:
        raise AssertionError(f"PackedArray flow with device='cpu' ran on {where}")
    for k in ref:
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"PackedArray flow: {k} on the card differs from the CPU")
    quick = {"wrap": [31, 16, 30], "sat_u": [31, 63, 30], "min_u": [1, 20, 10],
             "shl2": [4, 16, 8]}                # examples/quickstart.py's values
    for k, v in quick.items():
        if got[k].tolist() != v:
            raise AssertionError(f"PackedArray flow: {k} = {got[k].tolist()}, not {v}")
    say("PackedArray flow with no device named: every result on the card, equal "
        "to the CPU flow and quickstart's values; launches: "
        + ", ".join(f"{k} {counts[k]}" for k in K.SWAR_KERNELS))
    return {k: counts[k] for k in K.SWAR_KERNELS}


def chain_ms(torch, fn, x, *rest, inner=20, reps=7):
    """Median CUDA-event ms of one call in a chain ``x = fn(x, *rest)``."""
    for _ in range(2):
        x = fn(x, *rest)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            x = fn(x, *rest)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return median(out)


def phase_headline(torch, P):
    """bench.py:_run_headline on the card, and the other SWAR kernels' times.
    Each timed kernel is first held bit-identical to its plain version on the
    inputs it is timed on."""
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.ops.split64 import split_u64
    from pint_tpu_torch.utils.profiling import roofline_report

    from pint_tpu_torch.utils import timing

    def timed(name, kernel, plain, *args, plain_inner=3):
        """(kernel ms, plain ms, kernel ms of queued calls) of a chain on
        ``args``, after one call of each on them is held bit-identical."""
        same(torch, f"{name} at {tuple(args[0].shape)}", kernel(*args), plain(*args))
        return (chain_ms(torch, kernel, *args),
                chain_ms(torch, plain, *args, inner=plain_inner, reps=5),
                median(timing.queued_ms(lambda: kernel(*args))))

    lay = P.PackedLayout(8, 8, 8, 8)
    n = N_HEADLINE
    a = rand_words(torch, W, lay, (n,), 100)
    b = rand_words(torch, W, lay, (n,), 101)
    add = S.binop(lay, "add_unsigned_saturate")
    add_plain = lambda x, y: S.binop_plain(lay, "add_unsigned_saturate", x, y)
    same(torch, f"swar_binop add_unsigned_saturate at ({n},)", add(a, b), add_plain(a, b))
    raw_pre = chain_ms(torch, torch.add, a, b)
    k1 = chain_ms(torch, add, a, b)
    raw_post = chain_ms(torch, torch.add, a, b)
    k1_plain = chain_ms(torch, add_plain, a, b, inner=5, reps=5)
    raw_wps = n / (0.5 * (raw_pre + raw_post) / 1e3)
    wps = n / (k1 / 1e3)
    res = {
        "baseline_raw_u32_add_Gwords_per_s": raw_wps / 1e9,
        "addsat_u8x4_Gwords_per_s": wps / 1e9,
        "addsat_u8x4_Glanes_per_s": wps * lay.num_lanes / 1e9,
        "addsat_u8x4_vs_speed_of_light": wps / raw_wps,
        "addsat_u8x4_plain_Gwords_per_s": n / (k1_plain / 1e3) / 1e9,
        "addsat_u8x4_GB_per_s": wps * 12 / 1e9,
        "baseline_raw_u32_add_GB_per_s": raw_wps * 12 / 1e9,
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alu = sms * 64 * float(smi) * 1e6         # 64 int32 lanes an SM a clock
    roof = roofline_report(lay, {"add_unsigned_saturate": wps}, raw_wps * 12, alu)
    for k, v in res.items():
        say(f"headline {k} = {v}")
    say(f"headline roofline (memory bound = the raw add's {raw_wps * 12 / 1e9:.1f} GB/s, "
        f"ALU bound = {sms} SMs x 64 x {smi} MHz): {json.dumps(roof)}")
    if not res["addsat_u8x4_vs_speed_of_light"] >= SPEED_OF_LIGHT_MIN:
        raise AssertionError(
            f"K1 at {res['addsat_u8x4_vs_speed_of_light']:.3f} of the raw add, below "
            f"the limit {SPEED_OF_LIGHT_MIN}")

    times = {"swar_binop": (k1, k1_plain, median(timing.queued_ms(lambda: add(a, b))))}
    times["swar_shift"] = timed(
        "swar_shift shift_left(3)", S.shift(lay, "shift_left"),
        lambda x, k: S.shift_plain(lay, "shift_left", x, k), a, 3, plain_inner=5)
    d = rand_words(torch, W, lay, (ACCUM_STEPS, n), 102)
    times["swar_sat_accum"] = timed(
        f"swar_sat_accum steps={ACCUM_STEPS}",
        S.saturating_accumulate(lay, signed=False, steps=ACCUM_STEPS),
        lambda x, y: S.sat_accum_plain(lay, False, x, y), a, d)
    say(f"K9 shift_left(3) <8,8,8,8> {n} words: kernel {times['swar_shift'][0]:.4f} ms, "
        f"plain {times['swar_shift'][1]:.4f} ms; K8 unsigned steps={ACCUM_STEPS}: "
        f"kernel {times['swar_sat_accum'][0]:.4f} ms, plain "
        f"{times['swar_sat_accum'][1]:.4f} ms")

    lay64 = P.PackedLayout(*([8] * 8))
    a64 = rand_words(torch, W, lay64, (N_U64,), 103)
    b64 = rand_words(torch, W, lay64, (N_U64,), 104)
    pa, pb = split_u64(a64), split_u64(b64)
    add64 = S.binop(lay64, "add_unsigned_saturate")
    same(torch, f"swar_binop u64 add_unsigned_saturate at ({N_U64},)", add64(a64, b64),
         S.binop_plain(lay64, "add_unsigned_saturate", a64, b64))
    native = chain_ms(torch, add64, a64, b64)
    pair, pair_plain, _ = timed(
        "swar_binop_pair add_unsigned_saturate", S.binop_pair(lay64, "add_unsigned_saturate"),
        lambda x, y: S.binop_plain(lay64, "add_unsigned_saturate", x, y, pair=True), pa, pb)
    lanes = N_U64 * 8
    res["addsat_u8x8_u64_native_Glanes_per_s"] = lanes / (native / 1e3) / 1e9
    res["addsat_u8x8_u64_pair_Glanes_per_s"] = lanes / (pair / 1e3) / 1e9
    res["addsat_u8x8_u64_pair_plain_Glanes_per_s"] = lanes / (pair_plain / 1e3) / 1e9
    times["swar_binop_pair"] = (pair, pair_plain, median(timing.queued_ms(
        lambda: S.binop_pair(lay64, "add_unsigned_saturate")(pa, pb))))
    times["swar_shift_pair"] = timed(
        "swar_shift_pair shift_left(3)", S.shift_pair(lay64, "shift_left"),
        lambda x, k: S.shift_plain(lay64, "shift_left", x, k, pair=True), pa, 3)
    pd = split_u64(rand_words(torch, W, lay64, (ACCUM_STEPS, N_U64), 105))
    times["swar_sat_accum_pair"] = timed(
        f"swar_sat_accum_pair steps={ACCUM_STEPS}",
        S.saturating_accumulate(lay64, signed=False, steps=ACCUM_STEPS),
        lambda x, y: S.sat_accum_plain(lay64, False, x, y), pa, pd)
    for k in ("addsat_u8x8_u64_native_Glanes_per_s", "addsat_u8x8_u64_pair_Glanes_per_s",
              "addsat_u8x8_u64_pair_plain_Glanes_per_s"):
        say(f"u64 family <8 x 8> {N_U64} words: {k} = {res[k]}")
    say(f"K11b shift_pair(3): kernel {times['swar_shift_pair'][0]:.4f} ms, plain "
        f"{times['swar_shift_pair'][1]:.4f} ms; K11c pair steps={ACCUM_STEPS}: kernel "
        f"{times['swar_sat_accum_pair'][0]:.4f} ms, plain "
        f"{times['swar_sat_accum_pair'][1]:.4f} ms")
    return res, times


def lti_states(rng, b):
    return np.stack([rng.uniform(-3, 3, b), rng.uniform(-1, 1, b)], axis=-1)


def rti_states(rng, b):
    return np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                     rng.uniform(0, 1, b)], axis=-1)


def con_states(rng, b):
    return np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                     rng.uniform(-np.pi, np.pi, b)], axis=-1)


def make_csqp(P, sqp_iters, **dev_kw):
    return P.DeviceConstrainedSQP(
        P.DeviceSQP(sqp_iters=sqp_iters, device=DEVICE, **CON_SQP_KW, **dev_kw),
        **CON_KW)


def rel_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def phase_k6_k5(torch, P, timing):
    from pint_tpu_torch.mpc import pen_fused, pen_plain
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT, _alm_batched
    from pint_tpu_torch.models.dynamics import pack_controls

    csqp = make_csqp(P, 1)
    d = csqp.dev
    B = CON_BATCH
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(con_states(rng, B), dtype=torch.float32, device=DEVICE)
    lanes = torch.as_tensor(rng.integers(-60, 61, (B, d.n_dec), dtype=np.int32),
                            device=DEVICE)
    A, Bl, c = d._linearize_phase(x0, lanes)
    S_t = csqp._stack_constraints(*d._propagate_unrolled(A, Bl, c))[0]
    it = d.power_iters
    got = pen_fused(S_t, power_iters=it)
    ref = pen_plain(S_t, power_iters=it)
    torch.cuda.synchronize()
    for name, i in (("sqc", 0), ("sqj", 1), ("s_scale", 3)):
        if not torch.equal(got[i], ref[i]):
            raise AssertionError(f"K6: {int((got[i] != ref[i]).sum())} {name} "
                                 "entries differ from the plain version")
    errs = {name: rel_err(got[i], ref[i]) for name, i in (("pen_lip", 2),
                                                                   ("row_amp", 4))}
    if not max(errs.values()) <= 1e-5:
        raise AssertionError(f"K6: relative errors {errs} > 1e-5")
    differ = {name: int((got[i] != ref[i]).sum()) for name, i in (("pen_lip", 2),
                                                                   ("row_amp", 4))}
    k6_err = max(float((got[i] - ref[i]).abs().max()) for i in (2, 4))
    k6_ms = median(timing.cuda_ms(lambda: pen_fused(S_t, power_iters=it)))
    k6_q = median(timing.queued_ms(lambda: pen_fused(S_t, power_iters=it)))
    k6_pms = median(timing.cuda_ms(lambda: pen_plain(S_t, power_iters=it), reps=3))
    say(f"K6 pen C={csqp.n_rows} Tm={d.n_dec} B={B}: sqc, sqj, s_scale bit-identical; "
        f"rel err {errs}, problems differing in bits {differ}; kernel {k6_ms:.4f} ms, "
        f"plain {k6_pms:.4f} ms")

    o, _ = csqp._condense_constrained_dev(x0, lanes)
    lam = torch.as_tensor(rng.integers(0, 500, (B, csqp.padded_rows), dtype=np.int32),
                          device=DEVICE)
    sc = torch.stack([o[k] for k in RATIONALS])
    args = (lanes, o["g_pre"], o["hqt"], o["sqj"], o["sqc"], o["c_off"],
            o["lo_pre"], o["hi_pre"], lam, sc)
    kw = dict(outer=csqp.alm_outer, inners=d.pgd_iters, g_shift=d.g_shift,
              y_shift=_Y_SHIFT)
    out = alm_hqt(*args, **kw)
    ref = alm_hqt_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("words", out[0], ref[0]), ("lam", out[1], ref[1])):
        if not torch.equal(a, b):
            raise AssertionError(f"K5: {int((a != b).any(-1).sum())} problems' "
                                 f"{name} differ from the plain version")
    n = 256
    rest = [o[k][:n] for k in ("cs_num", "cs_den", "c_off", "lo_pre", "hi_pre",
                               "eh_num", "eh_den", "el_num", "el_den")]
    w_x, l_x = _alm_batched(
        pack_controls(lanes[:n]), o["g_pre"][:n], o["hqt"][..., :n].permute(2, 1, 0),
        o["hs_num"][:n], o["hs_den"][:n], o["sqc"][..., :n].permute(2, 0, 1),
        *rest, lam[:n], **kw)
    same(torch, "K5 against _alm_batched (words)", pack_controls(out[0][:n]), w_x)
    same(torch, "K5 against _alm_batched (lam)", out[1][:n], l_x)
    k5_ms = median(timing.cuda_ms(lambda: alm_hqt(*args, **kw)))
    k5_q = median(timing.queued_ms(lambda: alm_hqt(*args, **kw), calls=5))
    k5_pms = median(timing.cuda_ms(lambda: alm_hqt_plain(*args, **kw), reps=3))
    say(f"K5 alm Tp={d.n_dec} Cp={csqp.padded_rows} B={B} {csqp.alm_outer}x{d.pgd_iters}: "
        f"words and lam bit-identical to the plain version, and to _alm_batched on "
        f"{n} problems; kernel {k5_ms:.4f} ms, plain {k5_pms:.4f} ms")
    return (dict(max_abs_err=k6_err, ms=k6_ms, queued_ms=k6_q, plain_ms=k6_pms,
                 bits_differ=differ, C=csqp.n_rows, Tm=d.n_dec, power_iters=it),
            dict(max_abs_err=0.0, ms=k5_ms, queued_ms=k5_q, plain_ms=k5_pms,
                 Tp=d.n_dec, Cp=csqp.padded_rows, outer=csqp.alm_outer, inners=d.pgd_iters))


def phase_k7(torch, P, K, timing):
    """The LTI constrained solve through K7 (its main path: counts set to 0
    before ConstrainedPGD.solve and read after), then K7 against its plain
    version and the word-space solver."""
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc import alm_shared, alm_shared_plain

    T, dt, B = LTI_CON_T, 1.0 / 32.0, CON_BATCH
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    q = P.quantize_constrained(P.constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0)
    kw = dict(outer=LTI_CON_OUTER, inners=LTI_CON_INNERS, device=DEVICE)
    kern = P.ConstrainedPGD(q, **kw)
    word = P.ConstrainedPGD(q, fused=False, **kw)
    rng = np.random.default_rng(4)
    x0 = np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.2, 0.2, B)], -1)

    K.reset_launch_counts()                     # LTI constrained path starts
    words, U, lam = kern.solve(x0)
    torch.cuda.synchronize()
    launches = K.launch_counts()["alm_shared"]  # and ends here
    if launches < 1:
        raise AssertionError("kernel alm_shared never launched on ConstrainedPGD.solve")
    U = U.cpu().numpy()
    if U.shape != (B, T) or not np.isfinite(U).all() or np.abs(U).max() > 1.0 + 1e-6:
        raise AssertionError("ConstrainedPGD: controls not finite, bad shape or "
                             "outside the box")
    g = torch.as_tensor(q.qqp.g_lane_fixed(x0), device=DEVICE)
    co = torch.as_tensor(q.c_off_pre(x0), device=DEVICE)
    u0 = kern.init_words(B)
    w_x, l_x = word.solve_words(u0, g, co)
    same(torch, "K7 ConstrainedPGD words vs fused=False", words, w_x)
    same(torch, "K7 ConstrainedPGD lam vs fused=False", lam, l_x)
    o = kern._ops
    args = (unpack_controls(u0), g, co, torch.zeros_like(co), o["Hq"], o["Sq"],
            o["lo"], o["hi"])
    akw = dict(outer=LTI_CON_OUTER, inners=LTI_CON_INNERS, g_shift=q.qqp.g_shift,
               y_shift=q.y_shift, **kern._rationals)
    got = alm_shared(*args, **akw)
    ref = alm_shared_plain(*args, **akw)
    same(torch, "K7 lanes vs alm_shared_plain", got[0], ref[0])
    same(torch, "K7 lam vs alm_shared_plain", got[1], ref[1])
    ms = median(timing.cuda_ms(lambda: alm_shared(*args, **akw)))
    qms = median(timing.queued_ms(lambda: alm_shared(*args, **akw), calls=3))
    pms = median(timing.cuda_ms(lambda: alm_shared_plain(*args, **akw), reps=2,
                                warmup=1))
    solve_ms = median(timing.host_ms(lambda: kern.solve_words(u0, g, co), reps=5))
    word_ms = median(timing.host_ms(lambda: word.solve_words(u0, g, co), reps=2))
    rec = dict(launches=launches, max_abs_err=0.0, ms=ms, queued_ms=qms, plain_ms=pms,
               Tp=q.qqp.padded, Cp=q.padded_rows,
               solves_per_s=B / (solve_ms / 1e3), word_solves_per_s=B / (word_ms / 1e3))
    say(f"K7 ConstrainedPGD T={T} Tp={q.qqp.padded} Cp={q.padded_rows} B={B} "
        f"{LTI_CON_OUTER}x{LTI_CON_INNERS}: solve() through K7 (+{launches}), words and "
        f"lam bit-identical to fused=False and to the plain version; kernel {ms:.4f} "
        f"ms, plain {pms:.4f} ms; {rec['solves_per_s']:.1f} solves/s through K7, "
        f"{rec['word_solves_per_s']:.1f} word-space")
    return rec


def phase_k2(torch, P, timing):
    from pint_tpu_torch.mpc import FusedPGD, fused_pgd, fused_pgd_plain

    qqp = P.quantize(P.condense_double_integrator(T=50))
    rng = np.random.default_rng(1)
    dev = torch.device(DEVICE)
    g = torch.as_tensor(qqp.g_lane_fixed(lti_states(rng, LTI_BATCH)), device=dev)
    lanes = torch.as_tensor(
        rng.integers(-128, 128, (LTI_BATCH, qqp.padded), dtype=np.int32),
        device=dev)
    hq = torch.as_tensor(qqp.Hq, device=dev)
    beta = FusedPGD(qqp, device=DEVICE).beta_num
    rec = {}
    for iters in (15, 40):
        for momentum in (False, True):
            kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift,
                      iters=iters, momentum=momentum, beta_num=beta)
            out = fused_pgd(lanes, g, hq, **kw)
            ref = fused_pgd_plain(lanes, g, hq, **kw)
            torch.cuda.synchronize()
            err = int((out - ref).abs().max())
            if err:
                raise AssertionError(f"K2 iters={iters} momentum={momentum}: "
                                     f"max |kernel - plain| = {err}")
            ms = median(timing.cuda_ms(lambda: fused_pgd(lanes, g, hq, **kw)))
            qms = median(timing.queued_ms(lambda: fused_pgd(lanes, g, hq, **kw)))
            pms = median(timing.cuda_ms(
                lambda: fused_pgd_plain(lanes, g, hq, **kw), reps=5))
            key = f"iters{iters}_momentum{int(momentum)}"
            rec[key] = dict(max_abs_err=err, ms=ms, queued_ms=qms, plain_ms=pms,
                            Tp=qqp.padded, iters=iters)
            say(f"K2 fused_pgd B={LTI_BATCH} Tp={qqp.padded} {key}: bit-identical; "
                f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return rec


def profile_call(torch, fn):
    """One call of ``fn`` after a call to warm up, under torch.profiler:
    (device ms summed over the kernels it ran -- device events only, not
    the self device time the profiler also gives the operators that
    launched them --, (name, device ms) of each of those kernels, the input
    shapes of its ``aten::copy_`` calls)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == cuda]
    copies = [e.input_shapes for e in prof.events()
              if e.device_type != cuda and e.name == "aten::copy_"]
    return sum(ms for _, ms in kern), kern, copies


def phase_k3_k4(torch, P, K, timing):
    from pint_tpu_torch.models.dynamics import pack_controls
    from pint_tpu_torch.mpc import (lipq_fused, lipq_plain, pgd_fused_words_pre,
                                    pgd_fused_words_pre_plain, pgd_hqt, pgd_hqt_plain)
    from pint_tpu_torch.mpc.condense_fused import true_div

    sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **SQP_KW)
    rng = np.random.default_rng(2)
    x0 = torch.as_tensor(rti_states(rng, RTI_BATCH), dtype=torch.float32,
                         device=DEVICE)
    lanes = torch.as_tensor(
        rng.integers(-60, 61, (RTI_BATCH, sqp.n_dec), dtype=np.int32),
        device=DEVICE)
    Ht, g = sqp._condense_ht(x0, lanes)
    it = sqp.power_iters
    hqt, lip, hmax = lipq_fused(Ht, power_iters=it)
    hqt_p, lip_p, hmax_p = lipq_plain(Ht, power_iters=it)
    for name, a, b in (("hqt", hqt, hqt_p), ("h_max", hmax, hmax_p), ("lip", lip, lip_p)):
        same(torch, f"K3 {name}", a, b)
    k3_ms = median(timing.cuda_ms(lambda: lipq_fused(Ht, power_iters=it)))
    k3_q = median(timing.queued_ms(lambda: lipq_fused(Ht, power_iters=it)))
    k3_pms = median(timing.cuda_ms(
        lambda: lipq_plain(Ht, power_iters=it), reps=5))
    say(f"K3 lipq Tm={sqp.n_dec} B={RTI_BATCH}: hqt, h_max and lip bit-identical to the "
        f"plain version; device ms of queued calls {k3_q:.4f}, one call between events "
        f"{k3_ms:.4f}, plain {k3_pms:.4f}")

    alpha = true_div(1.0, lip)
    g_pre = sqp._g_pre_from(g, alpha)
    _, hs_num, hs_den = sqp._lipq_rationals(alpha, hmax)
    kw = dict(iters=sqp.pgd_iters, g_shift=sqp.g_shift)
    args = (g_pre, hqt, hs_num, hs_den)
    out = pgd_hqt(lanes, *args, **kw)
    same(torch, "K4 lanes vs pgd_hqt_plain", out, pgd_hqt_plain(lanes, *args, **kw))
    words = pack_controls(lanes)
    got = pgd_fused_words_pre(words, *args, **kw)
    same(torch, "K4 words vs unpack, pgd_hqt_plain, pack", got,
         pgd_fused_words_pre_plain(words, *args, **kw))
    same(torch, "K4 words vs lanes", got, pack_controls(out))
    launched = [n for n, _ in profile_call(
        torch, lambda: pgd_fused_words_pre(words, *args, **kw))[1]]
    if len(launched) != 1 or "pgd_hqt" not in launched[0]:
        raise AssertionError(f"K4 words entry ran {launched}, not one K4 launch")
    before = K.launch_counts()["pgd_hqt"]
    pgd_fused_words_pre(words, *args, **kw)
    if K.launch_counts()["pgd_hqt"] != before + 1:
        raise AssertionError("K4 words entry did not count one pgd_hqt launch")
    k4 = {}
    for name, fn, plain in (
            ("words", lambda: pgd_fused_words_pre(words, *args, **kw),
             lambda: pgd_fused_words_pre_plain(words, *args, **kw)),
            ("lanes", lambda: pgd_hqt(lanes, *args, **kw),
             lambda: pgd_hqt_plain(lanes, *args, **kw))):
        k4[name] = dict(queued_ms=median(timing.queued_ms(fn)),
                        ms=median(timing.cuda_ms(fn)),
                        plain_ms=median(timing.cuda_ms(plain, reps=5)))
    say(f"K4 pgd_hqt Tp={sqp.n_dec} B={RTI_BATCH} iters={sqp.pgd_iters}: lanes and words "
        f"bit-identical to their plain versions and to each other; the words entry is "
        f"one kernel ({launched[0]}); device ms of queued calls: words "
        f"{k4['words']['queued_ms']:.4f}, lanes {k4['lanes']['queued_ms']:.4f}; one call "
        f"between events: words {k4['words']['ms']:.4f}, lanes {k4['lanes']['ms']:.4f}; "
        f"plain: words {k4['words']['plain_ms']:.4f}, lanes {k4['lanes']['plain_ms']:.4f}")
    return (dict(max_abs_err=0.0, ms=k3_ms, queued_ms=k3_q, plain_ms=k3_pms,
                 Tm=Ht.shape[0], power_iters=it),
            dict(max_abs_err=0.0, ms=k4["words"]["ms"], queued_ms=k4["words"]["queued_ms"],
                 plain_ms=k4["words"]["plain_ms"], lanes=k4["lanes"],
                 kernels_a_words_call=launched, Tp=lanes.shape[1], iters=sqp.pgd_iters))


def phase_mpc(torch, P, K):
    qqp = P.quantize(P.condense_double_integrator(T=50))
    x0 = lti_states(np.random.default_rng(0), LTI_BATCH)
    # reference: the same first tick through the word-space solver (no kernel)
    ref = P.MPCService(qqp, batch=LTI_BATCH, iters_per_tick=15, use_fused=False,
                       device=DEVICE).solve(x0)
    K.reset_launch_counts()                     # serving path starts here
    svc = P.MPCService(qqp, batch=LTI_BATCH, iters_per_tick=15, device=DEVICE)
    if not (svc.g_on_device and type(svc._solver).__name__ == "FusedPGD"):
        raise AssertionError("MPCService on cuda did not select the K2 route")
    lat, first = [], None
    for _ in range(TICKS):
        u = svc.solve(x0)
        lat.append(svc.stats.last_latency_s * 1e3)
        first = u if first is None else first
        if u.shape != (LTI_BATCH, 50) or not np.isfinite(u).all():
            raise AssertionError("MPCService: controls not finite / bad shape")
        if np.abs(u).max() > qqp.qp.u_max + 1e-12:
            raise AssertionError("MPCService: controls outside the box")
    if not np.array_equal(first, ref):
        raise AssertionError("MPCService: first tick differs from word solver")
    n = K.launch_counts()["fused_pgd"]
    if n != TICKS:
        raise AssertionError(f"MPCService: K2 launched {n} times in {TICKS} ticks")
    rec = dict(p50_ms=pct(lat, 50), p99_ms=pct(lat, 99), ticks=TICKS,
               deadline_misses=svc.stats.deadline_misses)
    say(f"MPCService B={LTI_BATCH} T=50 15 it/tick: {TICKS} ticks, first tick "
        f"equals the word solver; K2 +{n}; tick p50 {rec['p50_ms']:.3f} ms, "
        f"p99 {rec['p99_ms']:.3f} ms")
    return rec


def phase_rti(torch, P, K):
    sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **SQP_KW)
    rti = P.RTIService(sqp, batch=RTI_BATCH)
    x0 = rti_states(np.random.default_rng(0), RTI_BATCH)
    from pint_tpu_torch.mpc import fused_alm

    # the words entry around K4 must not unpack or pack: count its calls
    wrapped = {}
    for name in ("unpack_controls", "pack_controls"):
        fn = getattr(fused_alm, name)
        wrapped[name] = [fn, 0]

        def counting(*a, _n=name, **k):
            wrapped[_n][1] += 1
            return wrapped[_n][0](*a, **k)
        setattr(fused_alm, name, counting)
    from pint_tpu_torch.mpc import propagate, reduce

    before, chain, red = K.launch_counts(), propagate.launch_count(), reduce.launch_count()
    box = 127 * np.asarray(sqp.model.lane_scales) + 1e-12
    try:
        for _ in range(TICKS):
            u = rti.solve(x0)
            if u.shape != (RTI_BATCH, 2) or not np.isfinite(u).all():
                raise AssertionError("RTIService: controls not finite / bad shape")
            if (np.abs(u) > box).any():
                raise AssertionError("RTIService: controls outside the box")
    finally:
        for name, (fn, _) in wrapped.items():
            setattr(fused_alm, name, fn)
    after, chain = K.launch_counts(), propagate.launch_count() - chain
    red = reduce.launch_count() - red
    for k in ("lipq", "pgd_hqt"):
        if after[k] - before[k] != TICKS:
            raise AssertionError(f"RTIService: {k} +{after[k] - before[k]}")
    if chain != TICKS or red != TICKS:
        raise AssertionError(f"RTIService: the chain kernel +{chain}, the reduce's +{red}")
    if any(n for _, n in wrapped.values()):
        raise AssertionError(f"RTIService: unpack/pack around K4: {wrapped}")
    say(f"RTIService B={RTI_BATCH} T=32 1x30/tick: {TICKS} ticks; chain +{chain}, reduce "
        f"+{red}, K3 +{TICKS}, K4 +{TICKS} on the words, no unpack or pack around it")
    return dict(ticks=TICKS, chain_launches=chain, reduce_launches=red)


def phase_crti(torch, P, K):
    csqp = make_csqp(P, 1)
    svc = P.ConstrainedRTIService(csqp, batch=CON_BATCH)
    x0 = con_states(np.random.default_rng(0), CON_BATCH)
    box = 127 * np.asarray(csqp.dev.model.lane_scales) + 1e-12
    from pint_tpu_torch.mpc import propagate, reduce, stack

    before, chain, red = K.launch_counts(), propagate.launch_count(), reduce.launch_count()
    rows = stack.launch_count()
    for _ in range(TICKS):
        u = svc.solve(x0)
        if u.shape != (CON_BATCH, 2) or not np.isfinite(u).all():
            raise AssertionError("ConstrainedRTIService: controls not finite / bad shape")
        if (np.abs(u) > box).any():
            raise AssertionError("ConstrainedRTIService: controls outside the box")
    after, chain = K.launch_counts(), propagate.launch_count() - chain
    red, rows = reduce.launch_count() - red, stack.launch_count() - rows
    for k in ("lipq", "pen", "alm"):
        if after[k] - before[k] != TICKS:
            raise AssertionError(f"ConstrainedRTIService: {k} +{after[k] - before[k]}")
    if chain != TICKS or red != TICKS or rows != TICKS:
        raise AssertionError(f"ConstrainedRTIService: the chain kernel +{chain}, the "
                             f"reduce's +{red}, the stacking's +{rows}")
    if int(svc._warm[1].abs().max()) == 0:
        raise AssertionError("ConstrainedRTIService: the corridor never bound")
    say(f"ConstrainedRTIService B={CON_BATCH} T=32 1x(3x30)/tick: {TICKS} ticks; chain, "
        f"reduce, stacking, K3, K6, K5 +{TICKS} each; the corridor bound")
    return dict(ticks=TICKS, chain_launches=chain, reduce_launches=red, stack_launches=rows)


def phase_con_flagship(torch, P, timing):
    from pint_tpu_torch.models.dynamics import unpack_controls

    kern, plain = make_csqp(P, 4), make_csqp(P, 4, use_kernels=False)
    x0 = con_states(np.random.default_rng(0), CON_BATCH).astype(np.float32)
    x0_t = torch.as_tensor(x0, device=DEVICE)
    u0 = kern.init_words(CON_BATCH)
    out = {}
    for name, csqp in (("kernels", kern), ("plain", plain)):
        words, lam = csqp.solve_words(u0, x0_t)
        lanes = unpack_controls(words)[:, : csqp.dev.n_dec].cpu().numpy()
        out[name] = (words, lam, csqp.dev.true_cost(x0, lanes),
                     csqp.violation(x0, lanes))
        ms = median(timing.host_ms(lambda: csqp.solve_words(u0, x0_t), reps=3))
        out[name + "_ms"] = ms
    (wk, lk, ck, vk), (wp, lp, cp, vp) = out["kernels"], out["plain"]
    cold = kern.dev.true_cost(x0, np.zeros((CON_BATCH, kern.dev.n_dec), np.int32))
    if not (np.isfinite(ck).all() and ck.mean() < cold.mean()):
        raise AssertionError("constrained flagship: costs not finite or no better "
                             "than cold")
    np.testing.assert_allclose(ck, cp, rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(vk, vp, atol=5e-3)
    differ = int(((wk != wp).any(-1) | (lk != lp).any(-1)).sum().item())
    rec = dict(
        solves_per_s=CON_BATCH / (out["kernels_ms"] / 1e3), ms=out["kernels_ms"],
        plain_solves_per_s=CON_BATCH / (out["plain_ms"] / 1e3),
        plain_ms=out["plain_ms"],
        max_rel_cost_diff=float(np.max(np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-12))),
        max_violation_diff=float(np.abs(vk - vp).max()),
        problems_differing=differ, mean_cost=float(ck.mean()),
        mean_cold_cost=float(cold.mean()), mean_violation=float(vk.mean()),
    )
    say(f"constrained flagship DeviceConstrainedSQP B={CON_BATCH} T=32 4x(3x30): cost "
        f"parity (max rel diff {rec['max_rel_cost_diff']:.3e}), violation parity (max "
        f"diff {rec['max_violation_diff']:.3e}), {differ} problems differ in bits; "
        f"mean cost {rec['mean_cost']:.4f} vs cold {rec['mean_cold_cost']:.4f}; "
        f"kernels {rec['solves_per_s']:.1f} solves/s ({rec['ms']:.3f} ms), plain "
        f"{rec['plain_solves_per_s']:.1f} solves/s")
    return rec


def phase_flagship(torch, P, timing):
    from pint_tpu_torch.models.dynamics import unpack_controls

    kern = P.DeviceSQP(sqp_iters=4, device=DEVICE, **SQP_KW)
    plain = P.DeviceSQP(sqp_iters=4, device=DEVICE, use_kernels=False, **SQP_KW)
    x0 = rti_states(np.random.default_rng(0), RTI_BATCH).astype(np.float32)
    x0_t = torch.as_tensor(x0, device=DEVICE)
    u0 = kern.init_words(RTI_BATCH)
    out = {}
    for name, sqp in (("kernels", kern), ("plain", plain)):
        words = sqp.solve_words(u0, x0_t)
        lanes = unpack_controls(words)[:, : sqp.n_dec].cpu().numpy()
        out[name] = (words, sqp.true_cost(x0, lanes))
        ms = median(timing.host_ms(lambda: sqp.solve_words(u0, x0_t), reps=5))
        out[name + "_solves_per_s"] = RTI_BATCH / (ms / 1e3)
        out[name + "_ms"] = ms
    ck, cp = out["kernels"][1], out["plain"][1]
    cold = kern.true_cost(x0, np.zeros((RTI_BATCH, kern.n_dec), np.int32))
    if not (np.isfinite(ck).all() and ck.mean() < cold.mean()):
        raise AssertionError("flagship: costs not finite or no better than cold")
    np.testing.assert_allclose(ck, cp, rtol=0.01, atol=1e-4)
    differ = int((out["kernels"][0] != out["plain"][0]).any(-1).sum().item())
    rec = dict(
        solves_per_s=out["kernels_solves_per_s"], ms=out["kernels_ms"],
        plain_solves_per_s=out["plain_solves_per_s"], plain_ms=out["plain_ms"],
        max_rel_cost_diff=float(np.max(np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-12))),
        problems_differing=differ, mean_cost=float(ck.mean()),
        mean_cold_cost=float(cold.mean()),
    )
    say(f"flagship DeviceSQP B={RTI_BATCH} T=32 4x30: cost parity with the plain "
        f"path (max rel diff {rec['max_rel_cost_diff']:.3e}, {differ} problems "
        f"differ in bits); kernels {rec['solves_per_s']:.1f} solves/s "
        f"({rec['ms']:.3f} ms), plain {rec['plain_solves_per_s']:.1f} solves/s")
    return rec


def phase_k2p(torch, P, K, timing):
    """K2p: FusedPGD(packed_io=True) at the LTI serving shape (its main
    path: counts set to 0 before solve() and read after), then K2p against
    K2 with its unpack and pack and against its plain version, timed."""
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
    from pint_tpu_torch.mpc import fused_pgd, fused_pgd_packed, fused_pgd_packed_plain

    qqp = P.quantize(P.condense_double_integrator(T=50))
    rng = np.random.default_rng(5)
    x0 = lti_states(rng, LTI_BATCH)
    K.reset_launch_counts()                     # K2p's main path starts here
    w_main, u = P.FusedPGD(qqp, iters=15, packed_io=True, device=DEVICE).solve(x0)
    torch.cuda.synchronize()
    launches = K.launch_counts()["fused_pgd_packed"]  # and ends here
    if launches < 1:
        raise AssertionError("kernel fused_pgd_packed never launched on FusedPGD.solve")
    same(torch, "K2p FusedPGD.solve vs packed_io=False",
         w_main, P.FusedPGD(qqp, iters=15, device=DEVICE).solve(x0)[0])
    if not torch.isfinite(u).all():
        raise AssertionError("FusedPGD(packed_io=True): controls not finite")
    g = torch.as_tensor(qqp.g_lane_fixed(x0), device=DEVICE)
    lanes = torch.as_tensor(rng.integers(-128, 128, (LTI_BATCH, qqp.padded), dtype=np.int32),
                            device=DEVICE)
    words = pack_controls(lanes)
    hq = torch.as_tensor(qqp.Hq, device=DEVICE)
    rec = {}
    for iters in (15, 40):
        kw = dict(hs_num=qqp.hs_num, hs_den=qqp.hs_den, g_shift=qqp.g_shift, iters=iters)

        def k2p():
            return fused_pgd_packed(words, g, hq, **kw)

        def k2_unpack_pack():
            return pack_controls(fused_pgd(unpack_controls(words), g, hq, **kw))

        got = k2p()
        same(torch, f"K2p iters={iters} vs K2 with unpack and pack", got, k2_unpack_pack())
        same(torch, f"K2p iters={iters} vs its plain version", got,
             fused_pgd_packed_plain(words, g, hq, **kw))
        # device time of queued calls, in turns: K2p, K2, K2 + unpack/pack, K2p
        ms = median(timing.queued_ms(k2p))
        k2_ms = median(timing.queued_ms(lambda: fused_pgd(lanes, g, hq, **kw)))
        k2_io_ms = median(timing.queued_ms(k2_unpack_pack))
        ms_again = median(timing.queued_ms(k2p))
        pms = median(timing.queued_ms(lambda: fused_pgd_packed_plain(words, g, hq, **kw),
                                      calls=2, reps=3))
        call_ms = median(timing.cuda_ms(k2p))
        rec[f"iters{iters}"] = dict(max_abs_err=0.0, ms=ms, ms_again=ms_again, k2_ms=k2_ms,
                                    k2_unpack_pack_ms=k2_io_ms, plain_ms=pms,
                                    single_call_ms=call_ms, Tp=qqp.padded, iters=iters)
        say(f"K2p fused_pgd_packed B={LTI_BATCH} Tp={qqp.padded} iters={iters}: words "
            f"bit-identical to K2 with unpack and pack and to the plain version; device ms "
            f"of queued calls: K2p {ms:.4f} ({ms_again:.4f} again), K2 alone {k2_ms:.4f}, "
            f"K2 with unpack and pack {k2_io_ms:.4f}, plain {pms:.4f}; one K2p call "
            f"between events {call_ms:.4f} ms")
    rec["launches"] = launches
    return rec


def phase_k10(torch, P, timing):
    """K10 alone on rank 0's slab of one real DeviceSQP lipq condensation
    and one DeviceConstrainedSQP condensation (Tm = 64, Cp = 64, B = 4096),
    at tp = 2 and 4, against its plain version, timed."""
    from pint_tpu_torch.mpc import pgd_matvec_cols, pgd_matvec_cols_plain

    sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **SQP_KW)
    rng = np.random.default_rng(6)
    lanes = torch.as_tensor(rng.integers(-60, 61, (RTI_BATCH, sqp.n_dec), dtype=np.int32),
                            device=DEVICE)
    x0 = torch.as_tensor(rti_states(rng, RTI_BATCH), dtype=torch.float32, device=DEVICE)
    hqt = sqp._condense(x0, lanes)[0]
    csqp = make_csqp(P, 1)
    xc = torch.as_tensor(con_states(rng, CON_BATCH), dtype=torch.float32, device=DEVICE)
    ops, _ = csqp._condense_constrained_dev(xc, lanes)
    rec = {}
    for tp in (2, 4):
        k = sqp.n_dec // tp
        lanes_r = lanes[:, :k].contiguous()
        for name, slab in (("sqp", hqt[:k]),
                           ("constrained", torch.cat([ops["hqt"][:k], ops["sqj"][:k]], 1))):
            got = pgd_matvec_cols(lanes_r, slab)
            same(torch, f"K10 tp={tp} {name}", got, pgd_matvec_cols_plain(lanes_r, slab))
            # device time of queued calls (a K10 launch is shorter than its
            # wrapper's host work), and one call between events
            ms = median(timing.queued_ms(lambda: pgd_matvec_cols(lanes_r, slab)))
            pms = median(timing.queued_ms(lambda: pgd_matvec_cols_plain(lanes_r, slab)))
            call_ms = median(timing.cuda_ms(lambda: pgd_matvec_cols(lanes_r, slab)))
            rows = slab.shape[1]
            rec[f"tp{tp}_{name}"] = dict(K=k, rows=rows, max_abs_err=0.0, ms=ms, plain_ms=pms,
                                         single_call_ms=call_ms,
                                         GB_per_s=k * rows * RTI_BATCH / (ms / 1e3) / 1e9)
            say(f"K10 pgd_matvec_cols tp={tp} {name} K={k} rows={rows} B={RTI_BATCH}: "
                f"bit-identical; device ms of queued calls: kernel {ms:.4f} "
                f"({rec[f'tp{tp}_{name}']['GB_per_s']:.1f} GB/s of slab), plain {pms:.4f}; "
                f"one kernel call between events {call_ms:.4f} ms")
    return rec


def phase_long(torch, P, K):
    """DeviceSQP and DeviceConstrainedSQP at T = 128 (Tm = 256: K3 with
    rows in registers, K6, K4, K5's cluster kernel), DeviceConstrainedSQP at
    T = 136 (C 136 x Tm 272: K3, K6's cluster kernel, K5), both at T = 144
    (Tm = 288, past K3's fit: the torch form, K4's and K5's cluster
    kernels), and DeviceConstrainedSQP with a 2-row constraint at T = 20
    (C 40 x Tm 40: K6's warp kernel): each stage's form, the kernels of each
    solve launched (counts set to 0 before it, read after) and no other
    condensation kernel, words and multipliers bit-identical to the plain
    versions', cost (and violation) parity, the chain's and the reduce's
    kernels once an SQP iteration, and the stacking's in the constrained
    solves."""
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc import propagate, reduce, stack

    rec = {}

    def sqp(T):
        return lambda **k: P.DeviceSQP(sqp_iters=LONG_SQP, device=DEVICE,
                                       **dict(SQP_KW, horizon=T), **k)

    def con(T, con_kw=CON_KW):
        return lambda **k: P.DeviceConstrainedSQP(P.DeviceSQP(
            sqp_iters=LONG_SQP, device=DEVICE, **dict(CON_SQP_KW, horizon=T), **k),
            **con_kw)

    cases = (
        ("device_sqp", LONG_T, LONG_BATCH, sqp(LONG_T), rti_states,
         ("lipq", "pgd_hqt"), ()),
        ("device_constrained", LONG_T, LONG_BATCH, con(LONG_T), con_states,
         ("lipq", "pen", "alm"), ()),
        ("device_constrained", PEN_T, PEN_BATCH, con(PEN_T), con_states,
         ("lipq", "pen", "alm"), ()),
        ("device_sqp", PAST_T, PAST_BATCH, sqp(PAST_T), rti_states,
         ("pgd_hqt",), ("lipq",)),
        ("device_constrained", PAST_T, PAST_BATCH, con(PAST_T), con_states,
         ("alm",), ("lipq", "pen")),
        ("device_constrained", TWO_ROW_T, TWO_ROW_BATCH, con(TWO_ROW_T, CON2_KW), con_states,
         ("lipq", "pen", "alm"), ()),
    )
    for name, T, B, make, states, launched, idle in cases:
        kern, plain = make(), make(use_kernels=False)
        x0 = states(np.random.default_rng(11), B).astype(np.float32)
        x0_t = torch.as_tensor(x0, device=DEVICE)
        u0 = kern.init_words(B)
        out, outs_lam = {}, {}
        for which, solver in (("kernels", kern), ("plain", plain)):
            if which == "kernels":
                K.reset_launch_counts()         # this phase's main path starts here
            t0 = time.perf_counter()
            res = solver.solve_words(u0, x0_t)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if which == "kernels":
                counts = K.launch_counts()      # and ends here
                chain, red = propagate.launch_count(), reduce.launch_count()
                rows = stack.launch_count()
            words = res[0] if isinstance(res, tuple) else res
            if isinstance(res, tuple):
                outs_lam[which] = res[1]
            dev = getattr(solver, "dev", solver)
            lanes = unpack_controls(words)[:, : dev.n_dec].cpu().numpy()
            out[which] = (words, dev.true_cost(x0, lanes), ms,
                          solver.violation(x0, lanes) if name != "device_sqp" else None)
        for k in launched:
            if counts[k] < 1:
                raise AssertionError(f"long horizon {name}: kernel {k} never launched")
        for k in idle:
            if counts[k]:
                raise AssertionError(f"long horizon {name}: {k} launched past its fit")
        if chain != LONG_SQP or red != LONG_SQP:
            raise AssertionError(f"long horizon {name}: the chain kernel +{chain}, the "
                                 f"reduce's +{red}, not once an SQP iteration")
        if rows != (LONG_SQP if name == "device_constrained" else 0):
            raise AssertionError(f"long horizon {name}: the stacking kernel +{rows}")
        (wk, ck, msk, vk), (wp, cp, msp, vp) = out["kernels"], out["plain"]
        if not np.isfinite(ck).all():
            raise AssertionError(f"long horizon {name}: costs not finite")
        np.testing.assert_allclose(ck, cp, rtol=0.01, atol=1e-4)
        if vk is not None:
            np.testing.assert_allclose(vk, vp, atol=5e-3)
        differ = int((wk != wp).any(-1).sum().item())
        if differ:
            raise AssertionError(f"long horizon {name}: {differ} problems' words differ "
                                 "from the plain versions'")
        if isinstance(res, tuple):
            lam_k, lam_p = outs_lam["kernels"], outs_lam["plain"]
            if not torch.equal(lam_k, lam_p):
                raise AssertionError(f"long horizon {name}: multipliers differ from the "
                                     "plain versions'")
        # the handoff past 64 lanes: no batch-last copy of Ht (Tm, Tm, B) and
        # no K6 transpose kernel in the solve
        dev_ms, kernels, copies = profile_call(torch, lambda: kern.solve_words(u0, x0_t))
        Tm = getattr(kern, "dev", kern).n_dec
        long = Tm > K.LONG_LANES
        transposes = sum("pen_transpose" in n for n, _ in kernels)
        ht_copies = sum(1 for shapes in copies if [Tm, Tm, B] in shapes)
        if long and (transposes or ht_copies):
            raise AssertionError(f"long horizon {name} T={T}: {transposes} K6 transpose "
                                 f"kernels and {ht_copies} copies of Ht in a solve past "
                                 "64 lanes")
        key = f"{name}_T{T}"
        rec[key] = dict(
            forms=kern.forms, batch=B, horizon=T, sqp_iters=LONG_SQP,
            launches={k: counts[k] for k in launched}, chain_launches=chain,
            reduce_launches=red, stack_launches=rows,
            kernels_ms=msk, plain_ms=msp,
            device_ms_per_iteration=dev_ms / LONG_SQP, kernels_per_iteration=len(kernels)
            / LONG_SQP, transpose_kernels=transposes, ht_copies=ht_copies,
            max_rel_cost_diff=float(np.max(np.abs(ck - cp) / np.maximum(np.abs(cp), 1e-12))),
            problems_differing=differ, mean_cost=float(ck.mean()))
        say(f"long horizon {name} T={T} B={B} {LONG_SQP} SQP: forms {kern.forms}; "
            f"launches {rec[key]['launches']}, chain +{chain}, reduce +{red}, stack +{rows}; "
            f"cost parity with the plain versions (max "
            f"rel diff {rec[key]['max_rel_cost_diff']:.3e}"
            f"{', violation parity' if vk is not None else ''}), {differ} problems differ "
            f"in bits; first solve {msk:.1f} ms, plain {msp:.1f} ms; "
            f"{dev_ms / LONG_SQP:.3f} ms of device time an SQP iteration, "
            f"{transposes} K6 transposes, {ht_copies} copies of Ht")
    return rec


def phase_long_kernels(torch, P, timing):
    """The long-horizon path's kernel shapes on real operands, each held to
    its plain version and timed: at T = 128, K3 with rows in registers (Tm
    256), K6's cluster kernel (C 128 x Tm 256), and K4's and K5's cluster
    kernels (Tp 256; 256 x 128); at T = 136 K6 again (136 x 272); at T = 144
    the cluster kernels again (288; 288 x 192); K6's warp kernel on the
    2-row constraint at T = 20 (40 x 40)."""
    from pint_tpu_torch.models.dynamics import pack_controls
    from pint_tpu_torch.mpc import (lipq_fused, lipq_plain, pen_fused, pen_plain,
                                    pgd_fused_words_pre, pgd_fused_words_pre_plain)
    from pint_tpu_torch.mpc.constrained import RATIONALS
    from pint_tpu_torch.mpc.fused_alm import alm_hqt, alm_hqt_plain
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT

    rec = {}

    def timed(key, fn, plain, outs, shape):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        err = 0.0
        for i, (name, exact) in enumerate(outs):
            if exact and not torch.equal(got[i], ref[i]):
                raise AssertionError(f"{key}: {name} differs from the plain version")
            if not exact:
                if not rel_err(got[i], ref[i]) <= 1e-5:
                    raise AssertionError(f"{key}: {name} rel err > 1e-5")
                err = max(err, float((got[i] - ref[i]).abs().max()))
        rec[key] = dict(shape, max_abs_err=err,
                        ms=median(timing.cuda_ms(fn, reps=5)),
                        queued_ms=median(timing.queued_ms(fn, calls=3, reps=3)),
                        plain_ms=median(timing.cuda_ms(plain, reps=1, warmup=0)))
        say(f"{key} {shape}: bit-identical to the plain version; kernel "
            f"{rec[key]['queued_ms']:.4f} ms queued, plain {rec[key]['plain_ms']:.1f} ms")

    for T, B in ((LONG_T, LONG_BATCH), (PEN_T, PEN_BATCH), (PAST_T, PAST_BATCH),
                 (TWO_ROW_T, TWO_ROW_BATCH)):
        csqp = P.DeviceConstrainedSQP(P.DeviceSQP(
            sqp_iters=1, device=DEVICE, **dict(CON_SQP_KW, horizon=T)),
            **(CON2_KW if T == TWO_ROW_T else CON_KW))
        d = csqp.dev
        rng = np.random.default_rng(T)
        x0 = torch.as_tensor(con_states(rng, B), dtype=torch.float32, device=DEVICE)
        lanes = torch.as_tensor(rng.integers(-60, 61, (B, d.n_dec), dtype=np.int32),
                                device=DEVICE)
        it = d.power_iters
        if T in (LONG_T, PEN_T, TWO_ROW_T):
            A, Bl, c = d._linearize_phase(x0, lanes)
            props = d._propagate_unrolled(A, Bl, c)
            Ht = d._reduce_sym(*props, x0)[0]
            S_t = csqp._stack_constraints(*props)[0]
            del A, Bl, c, props
            if T == LONG_T:
                timed("lipq (K3)", lambda: lipq_fused(Ht, power_iters=it),
                      lambda: lipq_plain(Ht, power_iters=it),
                      (("hqt", True), ("lip", True), ("h_max", True)),
                      dict(B=B, Tm=d.n_dec, power_iters=it))
            timed("pen (K6)" if T == LONG_T else f"pen (K6) T={T}",
                  lambda: pen_fused(S_t, power_iters=it),
                  lambda: pen_plain(S_t, power_iters=it),
                  (("sqc", True), ("sqj", True), ("pen_lip", False), ("s_scale", True),
                   ("row_amp", False)),
                  dict(B=B, C=csqp.n_rows, Tm=d.n_dec, power_iters=it))
            del Ht, S_t
        if T in (PEN_T, TWO_ROW_T):
            continue
        o, _ = csqp._condense_constrained_dev(x0, lanes)
        words = pack_controls(lanes)
        pk = dict(iters=d.pgd_iters, g_shift=d.g_shift)
        pargs = (words, o["g_pre"], o["hqt"], o["hs_num"], o["hs_den"])
        timed(f"pgd_hqt (K4) T={T}", lambda: (pgd_fused_words_pre(*pargs, **pk),),
              lambda: (pgd_fused_words_pre_plain(*pargs, **pk),), (("words", True),),
              dict(B=B, Tp=d.n_dec, iters=d.pgd_iters))
        lam = torch.as_tensor(rng.integers(0, 500, (B, csqp.padded_rows), dtype=np.int32),
                              device=DEVICE)
        sc = torch.stack([o[k] for k in RATIONALS])
        args = (lanes, o["g_pre"], o["hqt"], o["sqj"], o["sqc"], o["c_off"],
                o["lo_pre"], o["hi_pre"], lam, sc)
        kw = dict(outer=csqp.alm_outer, inners=d.pgd_iters, g_shift=d.g_shift,
                  y_shift=_Y_SHIFT)
        timed(f"alm (K5) T={T}", lambda: alm_hqt(*args, **kw),
              lambda: alm_hqt_plain(*args, **kw), (("lanes", True), ("lam", True)),
              dict(B=B, Tp=d.n_dec, Cp=csqp.padded_rows, outer=csqp.alm_outer,
                   inners=d.pgd_iters))
        if T == LONG_T:  # no iteration: the staging and the write-back alone
            k0 = dict(kw, outer=1, inners=0)
            timed(f"alm (K5) T={T} 1x0", lambda: alm_hqt(*args, **k0),
                  lambda: alm_hqt_plain(*args, **k0), (("lanes", True), ("lam", True)),
                  dict(B=B, Tp=d.n_dec, Cp=csqp.padded_rows, outer=1, inners=0))
        del o, args, pargs
    # K4 at the reference's widest pgd_viable horizon, on random operands,
    # hqt problem-major as the solvers hand it over
    B, Tp = LONG_BATCH, K4_WIDEST
    rng = np.random.default_rng(Tp)
    wargs = (torch.as_tensor(rng.integers(-127, 128, (B, Tp), dtype=np.int8)
                             .view(np.int32), device=DEVICE),
             torch.as_tensor(rng.integers(-2**18, 2**18, (B, Tp), dtype=np.int32),
                             device=DEVICE),
             torch.randint(-127, 128, (B, Tp, Tp), dtype=torch.int8,
                           device=DEVICE).permute(2, 1, 0),
             torch.as_tensor(rng.integers(1, 300, (B,), dtype=np.int32), device=DEVICE),
             torch.as_tensor(rng.integers(10, 16, (B,), dtype=np.int32), device=DEVICE))
    pk = dict(iters=30, g_shift=12)
    timed(f"pgd_hqt (K4) Tp={Tp}", lambda: (pgd_fused_words_pre(*wargs, **pk),),
          lambda: (pgd_fused_words_pre_plain(*wargs, **pk),), (("words", True),),
          dict(B=B, Tp=Tp, iters=30))
    return rec


CHAIN_SHAPES = ((32, 4096), (32, 16384), (128, 4096))   # (T, B): the benchmark's cells


def phase_chain(torch, P, timing):
    """The chain kernel at the benchmark's shapes: ``chain_fused`` against
    ``chain_plain`` on the card, Abar, Bbar and Cbar ``torch.equal``; one
    call between CUDA events, queued calls and the plain chain timed."""
    from pint_tpu_torch.mpc.propagate import chain_fused, chain_plain

    rec = {}
    for T, B in CHAIN_SHAPES:
        sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **dict(SQP_KW, horizon=T))
        rng = np.random.default_rng(T + B)
        x0 = torch.as_tensor(con_states(rng, B), dtype=torch.float32, device=DEVICE)
        lanes = torch.as_tensor(rng.integers(-128, 128, (B, 2 * T), dtype=np.int32),
                                device=DEVICE)

        def fused(sqp=sqp, x0=x0, lanes=lanes):
            return chain_fused(sqp, x0, lanes)

        def plain(sqp=sqp, x0=x0, lanes=lanes):
            return chain_plain(sqp, x0, lanes)

        got, ref = fused(), plain()
        for name, g, r in zip(("Abar", "Bbar", "Cbar"), got, ref, strict=True):
            if not torch.equal(g, r):
                raise AssertionError(f"chain kernel T={T} B={B}: {name} differs from the "
                                     "plain chain")
        del got, ref
        key = f"T={T} B={B}"
        rec[key] = dict(B=B, T=T, max_abs_err=0.0,
                        ms=median(timing.cuda_ms(fused, reps=5)),
                        queued_ms=median(timing.queued_ms(fused, calls=3, reps=3)),
                        plain_ms=median(timing.cuda_ms(plain, reps=3, warmup=1)))
        say(f"chain kernel T={T} B={B}: Abar, Bbar, Cbar equal to the plain chain; "
            f"{rec[key]['queued_ms']:.4f} ms queued, {rec[key]['ms']:.4f} ms one call, "
            f"plain {rec[key]['plain_ms']:.2f} ms")
    return rec


def phase_reduce(torch, P, timing):
    """The reduce kernel at the benchmark's shapes, on the chain kernel's
    stacks: ``reduce_fused`` against ``reduce_plain`` on the card, Ht and g
    ``torch.equal`` as int32 bits; one call between CUDA events, queued
    calls, the plain version and the torch ``_reduce_sym`` it replaces
    timed."""
    from pint_tpu_torch.mpc.propagate import chain_fused
    from pint_tpu_torch.mpc.reduce import reduce_fused, reduce_plain

    rec = {}
    for T, B in CHAIN_SHAPES:
        sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **dict(CON_SQP_KW, horizon=T))
        rng = np.random.default_rng(T + B + 1)
        x0 = torch.as_tensor(con_states(rng, B), dtype=torch.float32, device=DEVICE)
        lanes = torch.as_tensor(rng.integers(-128, 128, (B, 2 * T), dtype=np.int32),
                                device=DEVICE)
        args = (*chain_fused(sqp, x0, lanes), x0)

        def fused(sqp=sqp, args=args):
            return reduce_fused(sqp, *args)

        def plain(sqp=sqp, args=args):
            return reduce_plain(sqp, *args)

        def sym(sqp=sqp, args=args):
            return sqp._reduce_sym(*args)

        got, ref = fused(), plain()
        for name, g, r in zip(("Ht", "g"), got, ref, strict=True):
            if not torch.equal(g.contiguous().view(torch.int32), r.contiguous().view(torch.int32)):
                raise AssertionError(f"reduce kernel T={T} B={B}: {name} differs from the "
                                     "plain version")
        del got, ref
        key = f"T={T} B={B}"
        rec[key] = dict(B=B, T=T, max_abs_err=0.0,
                        ms=median(timing.cuda_ms(fused, reps=5)),
                        queued_ms=median(timing.queued_ms(fused, calls=3, reps=3)),
                        plain_ms=median(timing.cuda_ms(plain, reps=3, warmup=1)),
                        sym_ms=median(timing.cuda_ms(sym, reps=3, warmup=1)))
        say(f"reduce kernel T={T} B={B}: Ht, g equal to the plain version; "
            f"{rec[key]['queued_ms']:.4f} ms queued, {rec[key]['ms']:.4f} ms one call, "
            f"plain {rec[key]['plain_ms']:.2f} ms, _reduce_sym {rec[key]['sym_ms']:.3f} ms")
    return rec


STACK_SHAPES = ((3, 32, 4096), (3, 32, 16384), (3, 128, 4096), (6, 16, 4096))
"""(n, T, B) of the constrained cells: crti_t32 (both fleets), crti_t128,
cquad_t16."""


def phase_stack(torch, P, timing):
    """The stacking kernel at the constrained cells' shapes, on the chain
    kernel's stacks and the cells' one-hot F: ``stack_fused`` against
    ``stack_plain`` on the card, S_t, P_t and r_t ``torch.equal`` as int32
    bits (and to the einsums', zeros' signs aside); one call between CUDA
    events, queued calls, the plain version and the einsums it replaces
    (``DeviceConstrainedSQP._stack_einsum``) timed."""
    from pint_tpu_torch.mpc.propagate import chain_fused
    from pint_tpu_torch.mpc.stack import stack_fused, stack_plain

    rec = {}
    for n, T, B in STACK_SHAPES:
        if n == 6:
            kw, con, states = dict(QUAD_KW, horizon=T, model=P.PlanarQuadrotor()), QUAD_CON, (
                lambda rng, b: model_states("quadrotor", rng, b))
        else:
            kw, con, states = dict(CON_SQP_KW, horizon=T), CON_KW, con_states
        csqp = P.DeviceConstrainedSQP(P.DeviceSQP(device=DEVICE, **dict(kw, sqp_iters=1)),
                                      **con)
        F = csqp._F
        rng = np.random.default_rng(T + B + 2)
        x0 = torch.as_tensor(states(rng, B), dtype=torch.float32, device=DEVICE)
        lanes = torch.as_tensor(rng.integers(-128, 128, (B, 2 * T), dtype=np.int32),
                                device=DEVICE)
        args = chain_fused(csqp.dev, x0, lanes)

        def fused(F=F, args=args):
            return stack_fused(F, *args)

        def plain(F=F, args=args):
            return stack_plain(F, *args)

        def einsum(csqp=csqp, args=args):
            return csqp._stack_einsum(*args)

        got, ref, ein = fused(), plain(), einsum()
        for name, g, r, e in zip(("S_t", "P_t", "r_t"), got, ref, ein, strict=True):
            if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
                raise AssertionError(f"stacking kernel n={n} T={T} B={B}: {name} differs "
                                     "from the plain version")
            if not torch.equal(g + 0.0, e + 0.0):
                raise AssertionError(f"stacking kernel n={n} T={T} B={B}: {name} differs "
                                     "from the einsums' on a one-hot F")
        del got, ref, ein
        key = f"n={n} T={T} B={B}"
        rec[key] = dict(B=B, T=T, n=n, Tm=2 * T, Cs=1, max_abs_err=0.0,
                        ms=median(timing.cuda_ms(fused, reps=5)),
                        queued_ms=median(timing.queued_ms(fused, calls=3, reps=3)),
                        plain_ms=median(timing.cuda_ms(plain, reps=3, warmup=1)),
                        einsum_ms=median(timing.cuda_ms(einsum, reps=3, warmup=1)))
        say(f"stacking kernel n={n} T={T} B={B}: S_t, P_t, r_t equal to the plain version "
            f"and to the einsums'; {rec[key]['queued_ms']:.4f} ms queued, "
            f"{rec[key]['ms']:.4f} ms one call, plain {rec[key]['plain_ms']:.2f} ms, "
            f"einsums {rec[key]['einsum_ms']:.3f} ms")
        del args
    return rec


def wide_operands(torch, B, Tp, seed):
    """Random warm lanes (-128 occurs), g within 2^20 of 0 and of int32's
    extremes, and a symmetric int8 Hessian with a strong diagonal, on the
    card: the wide forms' bits do not depend on where the operands came
    from, and a QP's condensation at Tp = 2048 takes minutes on the host."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-60, 61, (Tp, Tp))
    hq = np.clip((a + a.T) // 2 + 127 * np.eye(Tp, dtype=np.int64), -127, 127)
    g = rng.integers(-2**20, 2**20, (B, Tp), dtype=np.int64)
    edge = rng.integers(0, 2, (B, Tp)) == 1
    g = np.where(edge & (rng.integers(0, 4, (B, Tp)) == 0),
                 np.where(g > 0, 2**31 - 1 - g, -2**31 - g), g).astype(np.int32)

    def t(x):
        return torch.as_tensor(x, device=DEVICE)

    return (t(rng.integers(-128, 128, (B, Tp), dtype=np.int32)), t(g),
            t(hq.astype(np.int8)))


def phase_wide(torch, P, K, timing):
    """K2, K2p (momentum off and on for K2) and K7 past 256 lanes (the wide
    forms: each pass one product across the batch in tiles of 64 problems
    x 128 columns, K7's second pass 64 x 64, one cooperative launch a
    call): the users' path, FusedPGD
    (K2, K2p) and ConstrainedPGD (K7) solves at T = 260, counts set to 0
    before and read after, equal to the word-space solvers; then each
    public wrapper at Tp = 260, 512 and 2048 (K7 also at (Tp, Cp) = (512,
    256), (512, 512)) on B = 4096 random operands, bit-identical to its
    plain version, timed queued, one call between CUDA events, and the
    plain version, and queued with no iteration (staging and write-back
    alone: ``staging_queued_ms``)."""
    from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
    from pint_tpu_torch.mpc import (alm_shared, alm_shared_plain, fused_pgd,
                                    fused_pgd_packed, fused_pgd_packed_plain,
                                    fused_pgd_plain)

    T, B = WIDE_TP[0], WIDE_BATCH
    dt = 1.0 / 32.0
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    qqp = P.quantize(qp, pad_to=4)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    qc = P.quantize_constrained(P.constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0, pad_to=4)
    rng = np.random.default_rng(60)
    x0 = lti_states(rng, B)
    solvers = dict(
        k2=P.FusedPGD(qqp, iters=WIDE_ITERS, device=DEVICE),
        k2m=P.FusedPGD(qqp, iters=WIDE_ITERS, momentum=True, device=DEVICE),
        k2p=P.FusedPGD(qqp, iters=WIDE_ITERS, packed_io=True, device=DEVICE))
    con = P.ConstrainedPGD(qc, outer=WIDE_K7_OUTER, inners=WIDE_K7_INNERS, device=DEVICE)
    K.reset_launch_counts()                      # the wide path starts
    words = {k: s.solve(x0)[0] for k, s in solvers.items()}
    cw, _, clam = con.solve(x0)
    torch.cuda.synchronize()
    path = K.launch_counts()                     # and ends here
    for name, n in (("fused_pgd", 2), ("fused_pgd_packed", 1), ("alm_shared", 1)):
        if path[name] != n:
            raise AssertionError(f"wide path: {name} launched {path[name]} times, not {n}")
    ref, _ = P.FixedPointPGD(qqp, iters=WIDE_ITERS, device=DEVICE).solve(x0)
    same(torch, "wide K2 FusedPGD.solve vs FixedPointPGD", words["k2"], ref)
    same(torch, "wide K2p FusedPGD.solve vs FixedPointPGD", words["k2p"], ref)
    g = torch.as_tensor(qqp.g_lane_fixed(x0), device=DEVICE)
    m = solvers["k2m"]
    lanes = fused_pgd_plain(unpack_controls(m.init_words(B)), g, m._hq, hs_num=qqp.hs_num,
                            hs_den=qqp.hs_den, g_shift=qqp.g_shift, iters=WIDE_ITERS,
                            momentum=True, beta_num=m.beta_num)
    same(torch, "wide K2 momentum FusedPGD.solve vs plain", words["k2m"],
         pack_controls(lanes))
    gc = torch.as_tensor(qc.qqp.g_lane_fixed(x0), device=DEVICE)
    co = torch.as_tensor(qc.c_off_pre(x0), device=DEVICE)
    wx, lx = P.ConstrainedPGD(qc, outer=WIDE_K7_OUTER, inners=WIDE_K7_INNERS, fused=False,
                              device=DEVICE).solve_words(con.init_words(B), gc, co)
    same(torch, "wide K7 ConstrainedPGD.solve vs fused=False", cw, wx)
    same(torch, "wide K7 ConstrainedPGD.solve lam vs fused=False", clam, lx)
    say(f"wide path T={T} B={B}: FusedPGD (K2, momentum off and on, K2p) and "
        f"ConstrainedPGD (K7, Tp {qc.qqp.padded} Cp {qc.padded_rows}) through the wide "
        f"forms (+{path['fused_pgd']} +{path['fused_pgd_packed']} +{path['alm_shared']}), "
        f"equal to the word-space solvers")

    rec = {}

    def timed(key, fn, plain, shape, staging):
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"{key}: kernel differs from its plain version "
                                     f"({int((a != b).sum())})")
        rec[key] = dict(shape, max_abs_err=0.0, ms=median(timing.cuda_ms(fn, reps=3)),
                        queued_ms=median(timing.queued_ms(fn, calls=3, reps=3)),
                        plain_ms=median(timing.cuda_ms(plain, reps=1, warmup=0)),
                        staging_queued_ms=median(timing.queued_ms(staging, calls=3, reps=3)))
        say(f"{key} {shape}: bit-identical to the plain version; kernel "
            f"{rec[key]['queued_ms']:.4f} ms queued ({rec[key]['staging_queued_ms']:.4f} "
            f"with no iteration), plain {rec[key]['plain_ms']:.2f} ms")

    for Tp in WIDE_TP:
        lanes, g, hq = wide_operands(torch, B, Tp, Tp)
        words = pack_controls(lanes)
        kw = dict(hs_num=33, hs_den=9, g_shift=12, iters=WIDE_ITERS)
        kw0 = dict(kw, iters=0)
        for mom in (False, True):
            mkw = dict(kw, momentum=mom, beta_num=150 if mom else 0)
            timed(f"fused_pgd (K2) Tp={Tp} momentum={int(mom)}",
                  lambda: (fused_pgd(lanes, g, hq, **mkw),),
                  lambda: (fused_pgd_plain(lanes, g, hq, **mkw),),
                  dict(B=B, Tp=Tp, iters=WIDE_ITERS),
                  lambda: fused_pgd(lanes, g, hq, **dict(mkw, iters=0)))
        timed(f"fused_pgd_packed (K2p) Tp={Tp}",
              lambda: (fused_pgd_packed(words, g, hq, **kw),),
              lambda: (fused_pgd_packed_plain(words, g, hq, **kw),),
              dict(B=B, Tp=Tp, iters=WIDE_ITERS, packed=True),
              lambda: fused_pgd_packed(words, g, hq, **kw0))
        del lanes, g, hq, words
    akw = dict(hs_num=37, hs_den=14, cs_num=91, cs_den=12, eh_num=55, eh_den=16,
               el_num=23, el_den=11, outer=WIDE_K7_OUTER, inners=WIDE_K7_INNERS,
               g_shift=12, y_shift=9)
    for Tp, Cp in WIDE_K7:
        lanes, g, hq = wide_operands(torch, B, Tp, Tp + Cp)
        r = np.random.default_rng(Cp)

        def t(x):
            return torch.as_tensor(x, device=DEVICE)

        args = (lanes, g, t(r.integers(-3000, 3000, (B, Cp), dtype=np.int32)),
                t(r.integers(0, 500, (B, Cp), dtype=np.int32)), hq,
                t(r.integers(-127, 128, (Cp, Tp), dtype=np.int8)),
                t(r.integers(-2000, -100, (Cp,), dtype=np.int32)),
                t(r.integers(100, 2000, (Cp,), dtype=np.int32)))
        timed(f"alm_shared (K7) Tp={Tp} Cp={Cp}", lambda: alm_shared(*args, **akw),
              lambda: alm_shared_plain(*args, **akw),
              dict(B=B, Tp=Tp, Cp=Cp, outer=WIDE_K7_OUTER, inners=WIDE_K7_INNERS),
              lambda: alm_shared(*args, **dict(akw, outer=0, inners=0)))
        del args, lanes, g, hq
    return rec, path


def phase_rollouts(torch, P, timing):
    """bench.py's rollouts section on the card: DoubleIntegrator.
    rollout_packed at B = 8192, H = 52 from seeded words (plain int32 torch
    ops, no kernel of the reference), bit-identical to the same rollout on
    the CPU; rollouts/s by the host clock and the device time
    (torch.profiler)."""
    model = P.DoubleIntegrator()
    rng = np.random.default_rng(0)
    lanes = rng.integers(-128, 128, (ROLL_BATCH, ROLL_H), dtype=np.int32)
    words = P.pack_controls(torch.as_tensor(lanes))
    st0 = np.stack([rng.integers(-2**20, 2**20, ROLL_BATCH),
                    rng.integers(-2**18, 2**18, ROLL_BATCH)], -1).astype(np.int32)
    w_d, s_d = words.to(DEVICE), torch.as_tensor(st0, device=DEVICE)
    got = model.rollout_packed(s_d, w_d)
    ref = model.rollout_packed(torch.as_tensor(st0), words)
    if got.shape != (ROLL_BATCH, ROLL_H + 1, 2) or not torch.equal(got.cpu(), ref):
        raise AssertionError("rollouts: the card's rollout differs from the CPU's")
    ms = median(timing.host_ms(lambda: model.rollout_packed(s_d, w_d), reps=10))
    dev_ms = profile_call(torch, lambda: model.rollout_packed(s_d, w_d))[0]
    rec = dict(rollouts_per_s_b8192_h52=ROLL_BATCH / (ms / 1e3), host_ms=ms,
               device_ms=dev_ms, B=ROLL_BATCH, H=ROLL_H)
    say(f"rollouts DoubleIntegrator B={ROLL_BATCH} H={ROLL_H}: bit-identical to the "
        f"CPU; {rec['rollouts_per_s_b8192_h52']:.1f} rollouts/s by the host clock "
        f"({ms:.3f} ms a call), {dev_ms:.4f} ms of device time")
    return rec


def phase_controller(torch, P, K, timing):
    """ConstrainedController at tests/test_constrained.py:256's configuration
    (double integrator T = 32, |v| <= 0.15, rho 50, 3 x 15 ALM a tick) on
    4096 seeded states for 50 ticks: K7 every tick (counts set to 0 before
    the run and read after), bit-identical to the same loop on the CPU (the
    word-space ALM), the velocity limit held; ticks/s by the host clock."""
    model = P.DoubleIntegrator()
    dt, T = model.dt, CTRL_T
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0, u_max=127 * model.u_scale)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    q = P.quantize_constrained(P.constrain_states(
        qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-CTRL_VMAX, hi=CTRL_VMAX), rho=50.0)
    rng = np.random.default_rng(70)
    x0 = np.stack([rng.uniform(-1.5, 1.5, CTRL_BATCH) * 2**16,
                   rng.uniform(-0.1, 0.1, CTRL_BATCH) * 2**16], -1).astype(np.int32)

    def make(device):
        return P.ConstrainedController(q, plant_step=lambda s, u: model.step(s, u[..., 0]),
                                       outer_per_tick=3, inners_per_outer=15, device=device)

    ctrl = make(DEVICE)
    x_d = torch.as_tensor(x0, device=DEVICE)
    ctrl.run(x_d, 1)
    torch.cuda.synchronize()
    K.reset_launch_counts()                      # the closed loop starts
    t0 = time.perf_counter()
    states, lanes = ctrl.run(x_d, CTRL_TICKS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = K.launch_counts()["alm_shared"]   # and ends here
    if launches != CTRL_TICKS:
        raise AssertionError(f"controller: K7 launched {launches} times in "
                             f"{CTRL_TICKS} ticks")
    s_c, l_c = make("cpu").run(torch.as_tensor(x0), CTRL_TICKS)
    same(torch, "controller states, card vs CPU", states.cpu(), s_c)
    same(torch, "controller lanes, card vs CPU", lanes.cpu(), l_c)
    v_max = float(np.abs(s_c.numpy()[..., 1]).max()) * 2.0**-16
    if not v_max < CTRL_VMAX + 0.01:
        raise AssertionError(f"controller: |v| reached {v_max}")
    tick_ms = median(timing.host_ms(lambda: ctrl.run(x_d, 5), reps=3)) / 5
    dev_ms = profile_call(torch, lambda: ctrl.run(x_d, 5))[0] / 5
    rec = dict(launches=launches, ticks=CTRL_TICKS, B=CTRL_BATCH,
               ticks_per_s=CTRL_TICKS / sec, tick_ms=tick_ms, device_ms_per_tick=dev_ms,
               max_abs_v=v_max)
    say(f"ConstrainedController B={CTRL_BATCH} T={T} {CTRL_TICKS} ticks: K7 every tick, "
        f"bit-identical to the CPU, max |v| {v_max:.4f} < {CTRL_VMAX} + 0.01; "
        f"{rec['ticks_per_s']:.1f} ticks/s by the host clock ({tick_ms:.3f} ms a tick), "
        f"{dev_ms:.4f} ms of device time a tick")
    return rec


def model_solvers(P, name, use_kernels):
    if name == "quadrotor":
        kw, con = dict(QUAD_KW, model=P.PlanarQuadrotor()), QUAD_CON
    else:
        kw, con = dict(PEND_KW, model=P.Pendulum()), PEND_CON
    sqp = P.DeviceSQP(device=DEVICE, use_kernels=use_kernels, **kw)
    return sqp, P.DeviceConstrainedSQP(
        P.DeviceSQP(device=DEVICE, use_kernels=use_kernels, **kw), **con)


def model_states(name, rng, B):
    if name == "quadrotor":
        return np.stack([rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
                         rng.uniform(-0.03, 0.03, B), rng.uniform(-0.2, 0.2, B),
                         rng.uniform(-0.2, 0.2, B), rng.uniform(-0.05, 0.05, B)],
                        -1).astype(np.float32)
    return np.stack([rng.uniform(-0.6, 0.6, B), rng.uniform(-0.1, 0.1, B)],
                    -1).astype(np.float32)


def phase_models(torch, P, K, timing):
    """The planar quadrotor (bench.py's quadrotor_device: T = 16, 4 x 30 and
    4 x (3 x 30), |vy| <= 0.15, rho 50) and the pendulum
    (tests/test_device_constrained.py:231's: T = 32, 4 x 20, |omega| <= 0.4)
    through DeviceSQP and DeviceConstrainedSQP at B = 4096, kernels against
    use_kernels=False: 0 problems differing in bits, cost parity (rtol 0.01,
    atol 1e-4), violation parity (atol 5e-3); K3, K4 (and K6, K5) launched
    in each solve (counts set to 0 before it, read after), and the stacking
    kernel once an SQP iteration of each constrained solve; solves/s by the
    host clock and the device time (torch.profiler)."""
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc import stack

    rec = {}
    for name in ("quadrotor", "pendulum"):
        x0 = model_states(name, np.random.default_rng(80), MODEL_BATCH)
        x_d = torch.as_tensor(x0, device=DEVICE)
        (sqp, csqp), (psqp, pcsqp) = (model_solvers(P, name, True),
                                      model_solvers(P, name, False))
        for kind, kern, plain, need in (
                ("device_sqp", sqp, psqp, ("lipq", "pgd_hqt")),
                ("device_constrained", csqp, pcsqp, ("lipq", "pen", "alm"))):
            con = kind == "device_constrained"
            d = kern.dev if con else kern
            K.reset_launch_counts()              # this solve's path starts
            out = kern.solve_words(kern.init_words(MODEL_BATCH), x_d)
            torch.cuda.synchronize()
            counts = K.launch_counts()           # and ends here
            rows = stack.launch_count()
            for k in need:
                if counts[k] < 1:
                    raise AssertionError(f"{name} {kind}: kernel {k} never launched")
            if rows != (d.sqp_iters if con else 0):
                raise AssertionError(f"{name} {kind}: the stacking kernel +{rows}")
            ref = plain.solve_words(plain.init_words(MODEL_BATCH), x_d)
            w, wp = (out[0], ref[0]) if con else (out, ref)
            differ = (w != wp).any(-1)
            if con:
                differ |= (out[1] != ref[1]).any(-1)
            lk = unpack_controls(w)[:, : d.n_dec].cpu().numpy()
            lp = unpack_controls(wp)[:, : d.n_dec].cpu().numpy()
            ck, cp = d.true_cost(x0, lk), d.true_cost(x0, lp)
            np.testing.assert_allclose(ck, cp, rtol=0.01, atol=1e-4)
            r = dict(forms=kern.forms, launches={k: counts[k] for k in need},
                     stack_launches=rows, problems_differing=int(differ.sum().item()),
                     max_rel_cost_diff=float(np.max(np.abs(ck - cp) /
                                                    np.maximum(np.abs(cp), 1e-12))),
                     mean_cost=float(ck.mean()))
            if con:
                vk, vp = kern.violation(x0, lk), kern.violation(x0, lp)
                np.testing.assert_allclose(vk, vp, atol=5e-3)
                r.update(max_violation_diff=float(np.abs(vk - vp).max()),
                         mean_violation=float(vk.mean()))
            if r["problems_differing"]:
                raise AssertionError(f"{name} {kind}: {r['problems_differing']} problems "
                                     "differ in bits from use_kernels=False")
            u0 = kern.init_words(MODEL_BATCH)
            ms = median(timing.host_ms(lambda: kern.solve_words(u0, x_d), reps=5))
            r.update(host_ms=ms, device_ms=profile_call(
                torch, lambda: kern.solve_words(u0, x_d))[0])
            key = f"{name}_{kind}_T{d.horizon}"
            r[f"{key}_solves_per_s"] = MODEL_BATCH / (ms / 1e3)
            rec[key] = r
            say(f"{key} B={MODEL_BATCH} forms {kern.forms}: 0 problems differ in bits, "
                f"cost parity (max rel diff {r['max_rel_cost_diff']:.3e}); "
                f"{r[f'{key}_solves_per_s']:.1f} solves/s by the host clock "
                f"({ms:.3f} ms), {r['device_ms']:.3f} ms of device time; "
                f"launches {r['launches']}")
    return rec


def phase_forms(torch, P):
    """Both flagship solvers (DeviceSQP at phase 11's configuration,
    DeviceConstrainedSQP at phase 12's), B = 4096, one SQP iteration in
    each propagate form (unroll, scan, allpairs, auto) and each reduce form
    (sym, einsum, blocked, btrans), at cost parity with unroll + sym
    (violation parity for the constrained one), with the device time of
    each (torch.profiler); then DeviceSQP's recursion (what "unroll",
    "scan" and "auto" run) against its one other computation, "allpairs",
    at T = 8, 16, 24, 32, 40 and 64.  The constrained tier runs the
    recursion in every propagate form (it needs the stacks)."""
    from pint_tpu_torch.models.dynamics import unpack_controls

    B = RTI_BATCH

    def solvers(T, form):
        sqp = P.DeviceSQP(sqp_iters=1, device=DEVICE, **dict(SQP_KW, horizon=T, **form))
        csqp = P.DeviceConstrainedSQP(P.DeviceSQP(
            sqp_iters=1, device=DEVICE, **dict(CON_SQP_KW, horizon=T, **form)), **CON_KW)
        return dict(device_sqp=sqp, device_constrained=csqp)

    def run(solver, x_d):
        out = solver.solve_words(solver.init_words(B), x_d)
        return out if isinstance(out, tuple) else (out,)

    def device_ms(solver, x_d):
        return profile_call(torch, lambda: run(solver, x_d))[0]

    rec = {"T32": {}, "crossover": {}}
    x0s = dict(device_sqp=rti_states(np.random.default_rng(5), B).astype(np.float32),
               device_constrained=con_states(np.random.default_rng(6), B).astype(np.float32))
    base = {}
    forms = [dict(propagate=p) for p in ("unroll", "scan", "allpairs", "auto")] + [
        dict(reduce=r) for r in ("einsum", "blocked", "btrans")]
    for form in forms:
        label = "+".join(f"{k}={v}" for k, v in form.items())
        for kind, s in solvers(32, form).items():
            x0 = x0s[kind]
            x_d = torch.as_tensor(x0, device=DEVICE)
            out = run(s, x_d)
            d = s.dev if kind == "device_constrained" else s
            lanes = unpack_controls(out[0])[:, : d.n_dec].cpu().numpy()
            cost = d.true_cost(x0, lanes)
            viol = s.violation(x0, lanes) if kind == "device_constrained" else None
            if label == "propagate=unroll":
                base[kind] = (cost, viol)
            np.testing.assert_allclose(cost, base[kind][0], rtol=0.01, atol=1e-4)
            if viol is not None:
                np.testing.assert_allclose(viol, base[kind][1], atol=5e-3)
            ms = device_ms(s, x_d)
            rec["T32"][f"{kind} {label}"] = dict(device_ms=ms, mean_cost=float(cost.mean()))
            say(f"forms {kind} T=32 B={B} {label}: cost parity with unroll+sym; "
                f"{ms:.3f} ms of device time an SQP iteration")
            del s, out
    x_d = torch.as_tensor(x0s["device_sqp"], device=DEVICE)
    for T in FORMS_T:
        r = {}
        for mode in ("unroll", "allpairs"):
            s = solvers(T, dict(propagate=mode))["device_sqp"]
            run(s, x_d)
            r[mode] = device_ms(s, x_d)
        rec["crossover"][f"device_sqp T={T}"] = r
        say(f"crossover device_sqp T={T}: unroll {r['unroll']:.3f} ms, allpairs "
            f"{r['allpairs']:.3f} ms of device time an SQP iteration")
    return rec


def costs_equal(what, got, ref):
    """Raises unless two float64 cost arrays are equal."""
    if got.shape != ref.shape or not np.array_equal(got, ref):
        raise AssertionError(f"{what}: the card's costs differ from the CPU's")


def phase_sqp_host(torch, P, timing):
    """Phase 23, the host SQP tier on the card: QuantizedSQP
    (tests/test_ltv.py:99: unicycle T = 32, 6 x 40) and ConstrainedSQP
    (tests/test_sqp_constrained.py's binding corridor: x_ref (1, 0, 0),
    F = [[0, 1, 0]], -+0.03, rho 100, 4 ALM outers) at SQP_HOST_BATCH seeded
    starts, then SQPController (one SQP iteration a tick) at SQPC_BATCH for
    SQPC_TICKS ticks.  Words, multipliers, cost histories, states and applied
    lanes bit-identical to the same solves on the CPU, for every
    SQP_CHECK_STRIDE-th problem.  Solves/s and ticks/s by the host clock;
    one SQP iteration split into its host condensation (ms) and its inner's
    device time (torch.profiler)."""
    from pint_tpu_torch.mpc.ltv import _pgd_batched_h
    from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT, _alm_batched

    rec = {}
    rng = np.random.default_rng(90)
    B = SQP_HOST_BATCH
    sub = np.arange(0, B, SQP_CHECK_STRIDE)
    x0, xc = rti_states(rng, B), con_states(rng, B)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    sqp = P.QuantizedSQP(device=DEVICE, **SQP_HOST_KW)
    (w, costs), sec = timed(lambda: sqp.solve(x0))
    wc, cc = dataclasses.replace(sqp, device="cpu").solve(x0[sub])
    same(torch, "QuantizedSQP words, card vs CPU", w.cpu()[sub], wc)
    costs_equal("QuantizedSQP", costs[sub], cc)
    lanes = sqp.lanes(w)
    t0 = time.perf_counter()
    ops = sqp._condense_batch(x0, lanes)
    host_ms = (time.perf_counter() - t0) * 1e3
    Hq, g, num, den = (torch.as_tensor(a, device=DEVICE) for a in ops)
    dev_ms, ev, _ = profile_call(torch, lambda: _pgd_batched_h(
        w, g, Hq, num, den, iters=sqp.pgd_iters, g_shift=sqp.g_shift))
    rec["quantized_sqp"] = dict(
        B=B, checked_on_cpu=len(sub), sec=sec, solves_per_s=B / sec,
        host_condense_ms_per_iter=host_ms, inner_device_ms_per_iter=dev_ms,
        inner_device_ops_per_iter=len(ev), mean_cost_first=float(costs[:, 0].mean()),
        mean_cost_last=float(costs[:, -1].mean()))
    say(f"QuantizedSQP B={B} T=32 6x40: words and cost histories bit-identical to the CPU "
        f"on {len(sub)} problems; {B / sec:.1f} solves/s by the host clock ({sec:.2f} s); "
        f"an iteration: host condensation {host_ms:.1f} ms, inner "
        f"{rec['quantized_sqp']['inner_device_ms_per_iter']:.3f} ms of device time in "
        f"{len(ev)} operations; mean cost {costs[:, 0].mean():.4f} -> {costs[:, -1].mean():.4f}")

    csqp = P.ConstrainedSQP(P.QuantizedSQP(device=DEVICE, **CSQP_KW), **CSQP_CON)
    (w, lam, costs), sec = timed(lambda: csqp.solve(xc))
    ccpu = dataclasses.replace(csqp, sqp=dataclasses.replace(csqp.sqp, device="cpu"))
    wc, lc, cc = ccpu.solve(xc[sub])
    same(torch, "ConstrainedSQP words, card vs CPU", w.cpu()[sub], wc)
    same(torch, "ConstrainedSQP multipliers, card vs CPU", lam.cpu()[sub], lc)
    costs_equal("ConstrainedSQP", costs[sub], cc)
    lanes = csqp.sqp.lanes(w)
    viol = csqp.violation(xc, lanes)
    t0 = time.perf_counter()
    ops, _ = csqp._condense_constrained(xc, lanes)
    host_ms = (time.perf_counter() - t0) * 1e3
    names = ("g_pre", "Hq", "hs_num", "hs_den", "Sq", "cs_num", "cs_den", "c_off", "lo_pre",
             "hi_pre", "eh_num", "eh_den", "el_num", "el_den")
    t_ops = [torch.as_tensor(ops[k], device=DEVICE) for k in names]
    dev_ms, ev, _ = profile_call(torch, lambda: _alm_batched(
        w, *t_ops, lam, outer=csqp.alm_outer, inners=csqp.sqp.pgd_iters,
        g_shift=csqp.sqp.g_shift, y_shift=_Y_SHIFT))
    rec["constrained_sqp"] = dict(
        B=B, checked_on_cpu=len(sub), sec=sec, solves_per_s=B / sec,
        host_condense_ms_per_iter=host_ms, inner_device_ms_per_iter=dev_ms,
        inner_device_ops_per_iter=len(ev), mean_violation=float(viol.mean()),
        max_violation=float(viol.max()), active_multipliers=int((lam != 0).any(-1).sum()))
    r = rec["constrained_sqp"]
    say(f"ConstrainedSQP B={B} T=32 6x(4x40) |y|<=0.03: words, multipliers and cost "
        f"histories bit-identical to the CPU on {len(sub)} problems; {B / sec:.1f} solves/s "
        f"by the host clock ({sec:.2f} s); an iteration: host condensation {host_ms:.1f} ms, "
        f"inner {r['inner_device_ms_per_iter']:.3f} ms of device time; violation mean "
        f"{r['mean_violation']:.2e}, max {r['max_violation']:.2e}")

    xs = x0[:SQPC_BATCH]
    ctl = P.SQPController(sqp, iters_per_tick=1)
    (states, applied), sec = timed(lambda: ctl.run(xs, SQPC_TICKS))
    csub = sub[sub < SQPC_BATCH]
    s_c, a_c = P.SQPController(dataclasses.replace(sqp, device="cpu")).run(xs[csub], SQPC_TICKS)
    if not (np.array_equal(states[csub], s_c) and np.array_equal(applied[csub], a_c)):
        raise AssertionError("SQPController: the card's loop differs from the CPU's")
    dist = np.linalg.norm(sqp.model.to_float(states)[:, -1, :2] - SQP_KW["x_ref"][:2], axis=-1)
    rec["sqp_controller"] = dict(B=SQPC_BATCH, ticks=SQPC_TICKS, checked_on_cpu=len(csub),
                                 sec=sec, ticks_per_s=SQPC_TICKS / sec,
                                 mean_final_distance=float(dist.mean()))
    say(f"SQPController B={SQPC_BATCH} {SQPC_TICKS} ticks: states and applied lanes "
        f"bit-identical to the CPU on {len(csub)} problems; {SQPC_TICKS / sec:.2f} ticks/s "
        f"by the host clock; mean distance to the goal {dist.mean():.4f}")
    return rec


def phase_lti_controllers(torch, P, K, timing):
    """Phase 24, the LTI controllers on K2.  RecedingHorizonController.build(
    DoubleIntegrator(u_shift=10), horizon=32, iters_per_tick=12) at RHC_BATCH
    seeded states for RHC_TICKS ticks, with use_fused=True (K2 every tick:
    counts set to 0 before the loop and read after) and use_fused=False, the
    two bit-identical to each other and to the CPU's loop.  Then the
    quadrotor hover LTIController (tests/test_quadrotor.py:56-72: T = 40,
    n = 6, m = 2, 25 iterations, error feedback) at HOVER_BATCH for
    HOVER_TICKS ticks, bit-identical to the CPU's loop on every
    HOVER_CHECK_STRIDE-th problem, and its use_fused=True,
    error_feedback=False form (K2 every tick) bit-identical to the word-space
    loop without error feedback.  torch.profiler must show one K2 launch a
    tick on both fused paths.  Ticks/s by the host clock and device ms a
    tick.  Returns the record and the K2 launches of the fused loops."""
    rec, launches = {}, 0
    rng = np.random.default_rng(100)

    def k2_per_tick(ctl, x, ticks=5):
        ms, ev, _ = profile_call(torch, lambda: ctl.run(x, ticks))
        k2 = [n for n, _ in ev if "fused_pgd" in n]
        if len(k2) != ticks:
            raise AssertionError(f"profiler: {len(k2)} K2 launches in {ticks} ticks")
        return ms / ticks, len(ev) / ticks

    def loop(ctl, x, ticks):
        """The fused closed loop, timed, with its K2 launches counted."""
        nonlocal launches
        ctl.run(x, 1)
        torch.cuda.synchronize()
        K.reset_launch_counts()                  # this loop's path starts
        t0 = time.perf_counter()
        out = ctl.run(x, ticks)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = K.launch_counts()["fused_pgd"]        # and ends here
        if n != ticks:
            raise AssertionError(f"K2 launched {n} times in {ticks} fused ticks")
        launches += n
        return out, sec

    model = P.DoubleIntegrator(u_shift=10)
    rhc = P.RecedingHorizonController.build(model, horizon=RHC_T, iters_per_tick=RHC_ITERS,
                                            device=DEVICE)
    fused = dataclasses.replace(rhc, use_fused=True)
    x0 = model.to_fixed(lti_states(rng, RHC_BATCH))
    x_d = torch.as_tensor(x0, device=DEVICE)
    (sf, lf), sec = loop(fused, x_d, RHC_TICKS)
    su, lu = rhc.run(x_d, RHC_TICKS)
    sc, lc = dataclasses.replace(rhc, device="cpu").run(torch.as_tensor(x0), RHC_TICKS)
    same(torch, "RecedingHorizonController states, fused vs word-space", sf, su)
    same(torch, "RecedingHorizonController lanes, fused vs word-space", lf, lu)
    same(torch, "RecedingHorizonController states, card vs CPU", sf.cpu(), sc)
    same(torch, "RecedingHorizonController lanes, card vs CPU", lf.cpu(), lc)
    dev_f, ops_f = k2_per_tick(fused, x_d)
    dev_u = profile_call(torch, lambda: rhc.run(x_d, 5))[0] / 5
    ms_f = median(timing.host_ms(lambda: fused.run(x_d, 5), reps=3)) / 5
    ms_u = median(timing.host_ms(lambda: rhc.run(x_d, 5), reps=3)) / 5
    pos = np.abs(model.to_float(sc.numpy()[:, -1, 0]))
    rec["receding_horizon"] = dict(
        B=RHC_BATCH, ticks=RHC_TICKS, Tp=rhc.qqp.padded, iters=RHC_ITERS, k2_launches=RHC_TICKS,
        ticks_per_s=RHC_TICKS / sec, fused_tick_ms=ms_f, word_space_tick_ms=ms_u,
        fused_device_ms_per_tick=dev_f, fused_device_ops_per_tick=ops_f,
        word_space_device_ms_per_tick=dev_u, mean_abs_final_position=float(pos.mean()))
    say(f"RecedingHorizonController B={RHC_BATCH} T={RHC_T} {RHC_TICKS} ticks: K2 once a "
        f"tick (launch count and profiler), fused = word-space = CPU bit for bit; "
        f"{RHC_TICKS / sec:.1f} ticks/s by the host clock; a tick {ms_f:.3f} ms fused, "
        f"{ms_u:.3f} ms word-space; device time a tick {dev_f:.4f} ms fused "
        f"({ops_f:.0f} operations), {dev_u:.4f} ms word-space")

    quad = P.PlanarQuadrotor()
    A, Bm = quad.hover_lti()
    Q = np.diag([4.0, 4.0, 2.0, 0.5, 0.5, 0.5])
    qqp = P.quantize(P.condense_lti(A, Bm, Q, 0.05, 10 * Q, HOVER_T, np.zeros(6),
                                    100 * quad.f_scale))

    def hover(fused_, ef, device=DEVICE):
        return P.LTIController(qqp, plant_step=lambda s, u: quad.step(s, u[..., 0], u[..., 1]),
                               inputs_per_step=2, iters_per_tick=HOVER_ITERS,
                               use_fused=fused_, error_feedback=ef, device=device)

    st = np.stack([rng.uniform(-0.6, 0.6, HOVER_BATCH), rng.uniform(-0.6, 0.6, HOVER_BATCH),
                   rng.uniform(-0.03, 0.03, HOVER_BATCH), rng.uniform(-0.2, 0.2, HOVER_BATCH),
                   rng.uniform(-0.2, 0.2, HOVER_BATCH), rng.uniform(-0.05, 0.05, HOVER_BATCH)],
                  -1)
    st[0] = [0.6, -0.4, 0.03, 0.0, 0.0, 0.0]
    x0 = quad.to_fixed(st)
    x_d = torch.as_tensor(x0, device=DEVICE)
    sub = np.arange(0, HOVER_BATCH, HOVER_CHECK_STRIDE)
    ef = hover(False, True)
    ef.run(x_d, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    se, le = ef.run(x_d, HOVER_TICKS)
    torch.cuda.synchronize()
    sec_ef = time.perf_counter() - t0
    s_c, l_c = hover(False, True, "cpu").run(torch.as_tensor(x0[sub]), HOVER_TICKS)
    same(torch, "hover LTIController states, card vs CPU", se.cpu()[sub], s_c)
    same(torch, "hover LTIController lanes, card vs CPU", le.cpu()[sub], l_c)
    traj = quad.to_float(s_c.numpy()[0])
    if not (np.abs(traj[-1, :2]).max() < 0.12 and abs(traj[-1, 2]) < 0.02):
        raise AssertionError(f"hover: the reference test's start ends at {traj[-1]}")
    fz, wz = hover(True, False), hover(False, False)
    (sf, lf), sec_f = loop(fz, x_d, HOVER_TICKS)
    sw, lw = wz.run(x_d, HOVER_TICKS)
    same(torch, "hover LTIController states, fused vs word-space", sf, sw)
    same(torch, "hover LTIController lanes, fused vs word-space", lf, lw)
    dev_f, ops_f = k2_per_tick(fz, x_d)
    dev_e = profile_call(torch, lambda: ef.run(x_d, 5))[0] / 5
    rec["quadrotor_hover"] = dict(
        B=HOVER_BATCH, ticks=HOVER_TICKS, Tp=qqp.padded, iters=HOVER_ITERS,
        checked_on_cpu=len(sub), k2_launches=HOVER_TICKS,
        error_feedback_ticks_per_s=HOVER_TICKS / sec_ef, fused_ticks_per_s=HOVER_TICKS / sec_f,
        error_feedback_device_ms_per_tick=dev_e, fused_device_ms_per_tick=dev_f,
        fused_device_ops_per_tick=ops_f)
    say(f"quadrotor hover LTIController B={HOVER_BATCH} Tp={qqp.padded} {HOVER_TICKS} ticks: "
        f"error feedback bit-identical to the CPU on {len(sub)} problems "
        f"({HOVER_TICKS / sec_ef:.1f} ticks/s, {dev_e:.4f} ms of device time a tick); fused "
        f"(K2 once a tick) = word-space without error feedback ({HOVER_TICKS / sec_f:.1f} "
        f"ticks/s, {dev_f:.4f} ms of device time a tick)")
    return rec, launches


def phase_planners(torch, P, timing):
    """Phase 25, the sampling and gradient planners.  QuantizedMPPI
    (horizon 50, 512 samples, tests/test_mppi.py's unicycle) at MPPI_BATCH
    seeded goals: ``plan`` with MPPI_UPDATES updates and a MPPI_TICKS-tick
    ``run_closed_loop``, on the card and on the CPU from one seeded CPU
    generator each (the same noise for both runs, drawn on the CPU); then
    QuantizedNonlinearPGD (horizon 48, 60 iterations) at NL_BATCH with
    goal_cost + obstacle_cost, the CPU solving every NL_CHECK_STRIDE-th
    problem.  Each held at cost parity (rtol 0.01, atol 1e-4) with the
    count of differing lanes.  Rollouts/s and solves/s by the host clock,
    and device time (torch.profiler)."""
    from pint_tpu_torch.models.dynamics import unpack_controls
    from pint_tpu_torch.mpc import costs as C

    rec = {}
    rng = np.random.default_rng(110)
    model = P.Unicycle(v_shift=10, w_shift=8)
    goals = np.stack([rng.uniform(-1.5, 1.5, MPPI_BATCH), rng.uniform(-1.5, 1.5, MPPI_BATCH)],
                     -1).astype(np.float32)
    cost = P.unicycle_goal_cost(model, goals[:, None, :])
    mppi = P.QuantizedMPPI(model, horizon=MPPI_H, samples=MPPI_K, noise_lanes=30,
                           device=DEVICE)
    cpu = dataclasses.replace(mppi, device="cpu")
    s0 = torch.zeros((MPPI_BATCH, 3), dtype=torch.int32)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def plan_cost(words):
        ctrl = unpack_controls(words.cpu()).reshape(MPPI_BATCH, MPPI_H, 2)
        return cost(model.rollout(s0, ctrl), ctrl).numpy()

    mppi.plan(gen(0), s0, cost, updates=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, best = mppi.plan(gen(7), s0, cost, updates=MPPI_UPDATES)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    wc, bc = cpu.plan(gen(7), s0, cost, updates=MPPI_UPDATES)
    ck, cc = plan_cost(w), plan_cost(wc)
    np.testing.assert_allclose(ck, cc, rtol=0.01, atol=1e-4)
    n_plan = int((unpack_controls(w).cpu() != unpack_controls(wc)).sum())
    sd, ad = mppi.run_closed_loop(gen(8), s0, cost, MPPI_TICKS)
    sc, ac = cpu.run_closed_loop(gen(8), s0, cost, MPPI_TICKS)
    lk, lc = cost(sd.cpu(), ad.cpu()).numpy(), cost(sc, ac).numpy()
    np.testing.assert_allclose(lk, lc, rtol=0.01, atol=1e-4)
    n_loop = int((sd.cpu() != sc).sum())
    dev_ms, ev, _ = profile_call(torch, lambda: mppi.step(gen(9), w, s0.to(DEVICE), cost))
    rollouts = MPPI_BATCH * MPPI_K * MPPI_UPDATES
    rec["mppi"] = dict(B=MPPI_BATCH, K=MPPI_K, H=MPPI_H, updates=MPPI_UPDATES,
                       rollouts_per_s=rollouts / sec, plan_sec=sec,
                       update_device_ms=dev_ms,
                       update_device_ops=len(ev), plan_lanes_differing=n_plan,
                       closed_loop_ticks=MPPI_TICKS, closed_loop_state_values_differing=n_loop,
                       mean_plan_cost=float(ck.mean()), mean_loop_cost=float(lk.mean()))
    say(f"QuantizedMPPI B={MPPI_BATCH} K={MPPI_K} H={MPPI_H}: plan ({MPPI_UPDATES} updates) and "
        f"a {MPPI_TICKS}-tick closed loop at cost parity with the CPU on the same noise "
        f"({n_plan} plan lanes, {n_loop} loop state values differ); {rollouts / sec:.1f} "
        f"rollouts/s by the host clock; an update {rec['mppi']['update_device_ms']:.3f} ms "
        f"of device time in {len(ev)} operations")

    nl = P.QuantizedNonlinearPGD(model, horizon=NL_H, iters=NL_ITERS, device=DEVICE)
    g_nl = np.stack([rng.uniform(1.2, 1.8, NL_BATCH), rng.uniform(-0.4, 0.4, NL_BATCH)],
                    -1).astype(np.float32)
    sub = np.arange(0, NL_BATCH, NL_CHECK_STRIDE)
    obst = [(0.8, 0.06)]

    def nl_cost(g):
        return C.combine(C.goal_cost(model, g), C.obstacle_cost(model, obst, radius=0.3))

    x0 = model.to_fixed(np.stack([rng.uniform(-0.1, 0.1, NL_BATCH),
                                  rng.uniform(-0.1, 0.1, NL_BATCH),
                                  rng.uniform(-0.05, 0.05, NL_BATCH)], -1))
    x_d = torch.as_tensor(x0, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, st = nl.solve(x_d, nl_cost(g_nl))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    wc, stc = dataclasses.replace(nl, device="cpu").solve(torch.as_tensor(x0[sub]),
                                                          nl_cost(g_nl[sub]))
    cf = nl_cost(g_nl[sub])

    def traj_cost(words, states):
        ctrl = unpack_controls(words.cpu()).reshape(-1, NL_H, 2).to(torch.float32)
        return cf(states.cpu(), ctrl).numpy()

    ck, cc = traj_cost(w[sub], st[sub]), traj_cost(wc, stc)
    np.testing.assert_allclose(ck, cc, rtol=0.01, atol=1e-4)
    n_nl = int((unpack_controls(w.cpu()[sub]) != unpack_controls(wc)).sum())
    dist = np.linalg.norm(st.cpu().numpy()[:, -1, :2] * 2.0**-16 - g_nl, axis=-1)
    short = dataclasses.replace(nl, iters=NL_PROFILE_ITERS)
    dev_ms, ev, _ = profile_call(torch, lambda: short.solve(x_d, nl_cost(g_nl)))
    rec["nonlinear"] = dict(B=NL_BATCH, H=NL_H, iters=NL_ITERS, sec=sec,
                            solves_per_s=NL_BATCH / sec, checked_on_cpu=len(sub),
                            lanes_differing=n_nl, lanes_checked=int(sub.size * 2 * NL_H),
                            device_ms_per_iter=dev_ms / NL_PROFILE_ITERS,
                            device_ops_per_iter=len(ev) / NL_PROFILE_ITERS,
                            mean_final_distance=float(dist.mean()))
    r = rec["nonlinear"]
    say(f"QuantizedNonlinearPGD B={NL_BATCH} H={NL_H} {NL_ITERS} iterations, goal + obstacle: "
        f"cost parity with the CPU on {len(sub)} problems ({n_nl} of {r['lanes_checked']} "
        f"lanes differ); {NL_BATCH / sec:.1f} solves/s by the host clock ({sec:.2f} s); "
        f"{r['device_ms_per_iter']:.3f} ms of device time an iteration in "
        f"{r['device_ops_per_iter']:.0f} operations; mean distance to the goal "
        f"{dist.mean():.4f}")
    return rec


def phase_swingup(torch, P):
    """Phase 26, examples/swingup.py's flow through the port on the card:
    Pendulum(u_shift=10), a QuantizedSQP plan at T = 128 (8 x 60) from
    hanging, then an SQPController tracker at T = 16 (1 x 40, pad_to 16)
    along the plan for SWING_TICKS ticks.  The plan's words and cost history
    bit-identical to the CPU's, the tracked loop's states too; it must end
    with |theta| < 0.02 turns, the example's own assertion."""
    model = P.Pendulum(u_shift=10)
    planner = P.QuantizedSQP(model=model, horizon=128, sqp_iters=8, pgd_iters=60,
                             Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]), qf_scale=80.0,
                             x_ref=np.zeros(2), device=DEVICE)
    x0 = np.array([[0.5, 0.0]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, costs = planner.solve(x0)
    plan_sec = time.perf_counter() - t0
    wc, cc = dataclasses.replace(planner, device="cpu").solve(x0)
    same(torch, "swing-up plan words, card vs CPU", w.cpu(), wc)
    costs_equal("swing-up plan", costs, cc)
    ref_traj = model.reference_rollout(x0[0], planner.plan_phys(w)[0])
    x_ref_traj = np.concatenate([ref_traj, np.zeros((SWING_TICKS + 16 - ref_traj.shape[0], 2))])
    tracker = P.QuantizedSQP(model=model, horizon=16, sqp_iters=1, pgd_iters=40,
                             Q=np.diag([1.0, 0.3]), R=np.array([[0.01]]), qf_scale=20.0,
                             x_ref=np.zeros(2), pad_to=16, device=DEVICE)
    t0 = time.perf_counter()
    states, applied = P.SQPController(tracker).run(x0, SWING_TICKS, x_ref_traj=x_ref_traj)
    track_sec = time.perf_counter() - t0
    s_c, a_c = P.SQPController(dataclasses.replace(tracker, device="cpu")).run(
        x0, SWING_TICKS, x_ref_traj=x_ref_traj)
    if not (np.array_equal(states, s_c) and np.array_equal(applied, a_c)):
        raise AssertionError("swing-up: the card's tracked loop differs from the CPU's")
    traj = model.to_float(states)[0]
    if not abs(traj[-1, 0]) < 0.02:
        raise AssertionError(f"swing-up: did not balance, final theta {traj[-1, 0]}")
    rec = dict(plan_cost_first=float(costs[0, 0]), plan_cost_last=float(costs[0, -1]),
               plan_sec=plan_sec, track_ticks=SWING_TICKS, track_sec=track_sec,
               track_ticks_per_s=SWING_TICKS / track_sec, final_theta=float(traj[-1, 0]),
               final_omega=float(traj[-1, 1]), plan_endpoint_theta=float(ref_traj[-1, 0]))
    say(f"swing-up: plan T=128 8x60 bit-identical to the CPU, cost {costs[0, 0]:.1f} -> "
        f"{costs[0, -1]:.1f} ({plan_sec:.2f} s); tracker T=16 {SWING_TICKS} ticks bit-identical "
        f"({SWING_TICKS / track_sec:.1f} ticks/s), final theta {traj[-1, 0]:+.5f} turns "
        f"(|theta| < 0.02: balanced)")
    return rec


def host_cpu() -> str:
    """The host CPU's model name as /proc/cpuinfo gives it, with the
    machine type and the count of logical CPUs where it names none."""
    import os
    import platform

    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if model.lower() in ("", "unknown"):
        return f"model not reported ({platform.machine()}, {os.cpu_count()} logical CPUs)"
    return model


def phase_native(torch, P, k1_queued_ms, smi):
    """Phase 27, the native host SWAR tier (pint_tpu_torch.native, host
    C++) against the card: on the substrate phase's layouts at N_CHECK
    full-range words, every NativeOps binop and shift bit-identical to K1
    and K9 on the same words (and, for u64 layouts, to K11a and K11b), its
    pack and both unpacks equal to ops/word on the card; then its host ms
    for add_unsigned_saturate at the headline's 16Mi <8,8,8,8> words, beside
    K1's queued ms from the headline."""
    from pint_tpu_torch.convert import words_to_numpy
    from pint_tpu_torch.native import NativeOps, _so_path
    from pint_tpu_torch.ops import swar as S
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.ops.split64 import merge_u64, split_u64

    def held(what, got, want):
        if not np.array_equal(words_to_numpy(got), want):
            raise AssertionError(f"native {what}: NativeOps differs from the card")

    t0 = time.perf_counter()
    NativeOps(P.PackedLayout(8, 8, 8, 8))
    build_sec = time.perf_counter() - t0
    checks = 0
    for seed, widths in enumerate(SWAR_LAYOUTS):
        lay = P.PackedLayout(*widths)
        nat = NativeOps(lay)
        wide = lay.word_bits == 64
        a = rand_words(torch, W, lay, (N_CHECK,), 10 * seed + 300)
        b = rand_words(torch, W, lay, (N_CHECK,), 10 * seed + 301)
        na, nb = words_to_numpy(a), words_to_numpy(b)
        pa, pb = (split_u64(a), split_u64(b)) if wide else (None, None)
        for op in S.BINOP_NAMES:
            want = getattr(nat, op)(na, nb)
            held(f"{op} {widths} vs K1", S.binop(lay, op)(a, b), want)
            checks += 1
            if wide:
                held(f"{op} {widths} vs K11a", merge_u64(S.binop_pair(lay, op)(pa, pb)), want)
                checks += 1
        for op in S.SHIFT_NAMES:
            for amt in SHIFT_AMOUNTS:
                want = getattr(nat, op)(na, amt)
                held(f"{op}({amt}) {widths} vs K9", S.shift(lay, op)(a, amt), want)
                checks += 1
                if wide:
                    held(f"{op}({amt}) {widths} vs K11b",
                         merge_u64(S.shift_pair(lay, op)(pa, amt)), want)
                    checks += 1
        lanes = nat.unpack(na, signed=True)
        held(f"pack {widths}", W.pack(lay, torch.as_tensor(lanes, device=DEVICE)),
             nat.pack(lanes))
        for signed, fn in ((False, W.unpack), (True, W.unpack_signed)):
            got = fn(lay, a).to(torch.int64).cpu().numpy()
            if not np.array_equal(got, nat.unpack(na, signed=signed)):
                raise AssertionError(f"native unpack signed={signed} {widths}: differs "
                                     "from ops/word on the card")
        checks += 3
    lay = P.PackedLayout(8, 8, 8, 8)
    nat = NativeOps(lay)
    a = rand_words(torch, W, lay, (N_HEADLINE,), 100)        # the headline's words
    b = rand_words(torch, W, lay, (N_HEADLINE,), 101)
    na, nb = words_to_numpy(a), words_to_numpy(b)
    held("add_unsigned_saturate at the headline's words",
         S.binop(lay, "add_unsigned_saturate")(a, b), nat.add_unsigned_saturate(na, nb))
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        nat.add_unsigned_saturate(na, nb)
        host.append((time.perf_counter() - t0) * 1e3)
    rec = dict(layouts=[list(w) for w in SWAR_LAYOUTS], words=N_CHECK, checks=checks,
               library=_so_path().name, build_and_load_sec=build_sec,
               headline_words=N_HEADLINE, native_host_ms=median(host),
               native_host_ms_readings=host, k1_queued_ms=k1_queued_ms,
               native_Gwords_per_s=N_HEADLINE / (median(host) / 1e3) / 1e9,
               card=smi, host_cpu=host_cpu())
    say(f"native: {checks} checks on {len(SWAR_LAYOUTS)} layouts x {N_CHECK} full-range "
        f"words, NativeOps bit-identical to K1/K9 (K11a/K11b for u64) and ops/word pack "
        f"and unpacks on the card; add_unsigned_saturate <8,8,8,8> at {N_HEADLINE} words: "
        f"host {median(host):.3f} ms ({host_cpu()}), K1 queued {k1_queued_ms:.4f} ms "
        f"({smi})")
    return rec


def phase_checkpoint(torch, P, K, timing):
    """Phase 28, checkpoints on the card: save_packed/load_packed of the
    headline's 16Mi words round trip bit-identical; the resume claim on K2
    at the LTI serving shape (FusedPGD 15 iterations against 7, a
    save_solver_state/load_solver_state and 8 more, momentum off), K2
    launched in each solve; the flagship DeviceSQP with fused=False (K3,
    then the word-space inner) bit-identical to fused=None (K3, then K4)."""
    import tempfile

    from pint_tpu_torch.convert import words_from_numpy
    from pint_tpu_torch.ops import word as W
    from pint_tpu_torch.utils import checkpoint as C

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        lay = P.PackedLayout(8, 8, 8, 8)
        arr = P.PackedArray(rand_words(torch, W, lay, (N_HEADLINE,), 100), lay)
        t0 = time.perf_counter()
        C.save_packed(f"{tmp}/words.npz", arr)
        t1 = time.perf_counter()
        back = C.load_packed(f"{tmp}/words.npz", device=DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if back.layout != lay or back.device.type != "cuda":
            raise AssertionError("load_packed: layout or device lost")
        same(torch, "save_packed/load_packed round trip", back.word, arr.word)
        rec.update(packed_words=N_HEADLINE, save_packed_ms=(t1 - t0) * 1e3,
                   load_packed_ms=(t2 - t1) * 1e3)

        qqp = P.quantize(P.condense_double_integrator(T=50))
        g = torch.as_tensor(qqp.g_lane_fixed(lti_states(np.random.default_rng(28), LTI_BATCH)),
                            device=DEVICE)
        launches = []

        def solve(iters, words):
            K.reset_launch_counts()             # this solve's path starts here
            out = P.FusedPGD(qqp, iters=iters, device=DEVICE).solve_words(words, g)
            torch.cuda.synchronize()
            launches.append(K.launch_counts()["fused_pgd"])   # and ends here
            if launches[-1] < 1:
                raise AssertionError(f"resume: K2 never launched in the {iters}-iteration solve")
            return out

        cold = P.FusedPGD(qqp, device=DEVICE).init_words(LTI_BATCH)
        want = solve(15, cold)
        part = solve(7, cold)
        C.save_solver_state(f"{tmp}/state.npz", part, g, iters_done=7, meta={"T": 50})
        u, g2, done, meta = C.load_solver_state(f"{tmp}/state.npz")
        got = solve(15 - done, words_from_numpy(u, device=DEVICE))
        if torch.equal(part, want):
            raise AssertionError("resume: 7 iterations already give the 15-iteration words")
        same(torch, "K2 resumed after save/load vs uninterrupted", got, want)
        if meta != {"T": 50} or not np.array_equal(g2, g.cpu().numpy()):
            raise AssertionError("resume: the state file lost its linear term or metadata")
        rec.update(resume=dict(B=LTI_BATCH, Tp=qqp.padded, iters=(15, 7, 15 - done),
                               k2_launches=launches))

    x0 = torch.as_tensor(rti_states(np.random.default_rng(0), RTI_BATCH), dtype=torch.float32,
                         device=DEVICE)
    words, counts, ms = {}, {}, {}
    for fused in (None, False):
        sqp = P.DeviceSQP(sqp_iters=4, fused=fused, device=DEVICE, **SQP_KW)
        u0 = sqp.init_words(RTI_BATCH)
        K.reset_launch_counts()                 # this solve's path starts here
        words[fused] = sqp.solve_words(u0, x0)
        torch.cuda.synchronize()
        counts[fused] = {k: K.launch_counts()[k] for k in ("lipq", "pgd_hqt")}
        ms[fused] = median(timing.host_ms(lambda: sqp.solve_words(u0, x0), reps=5))
    if counts[None]["lipq"] < 1 or counts[None]["pgd_hqt"] < 1 or counts[False]["lipq"] < 1:
        raise AssertionError(f"flagship fused=None/False: kernels not launched {counts}")
    if counts[False]["pgd_hqt"]:
        raise AssertionError("flagship fused=False launched K4")
    same(torch, "flagship DeviceSQP fused=False vs fused=None", words[False], words[None])
    rec.update(flagship_fused=dict(B=RTI_BATCH, launches={str(k): v for k, v in counts.items()},
                                   ms={str(k): v for k, v in ms.items()}))
    say(f"checkpoint: {N_HEADLINE} words save/load round trip bit-identical "
        f"({rec['save_packed_ms']:.1f} / {rec['load_packed_ms']:.1f} ms); K2 resume "
        f"(B={LTI_BATCH}, 15 = 7 + save/load + 8) bit-identical, K2 launches {launches}; "
        f"flagship DeviceSQP fused=False bit-identical to fused=None (launches "
        f"{json.dumps(rec['flagship_fused']['launches'])}; host ms "
        f"{ms[None]:.2f} with K4, {ms[False]:.2f} with the word-space inner)")
    return rec


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tier_problems(torch, P):
    """The four sharded solves' configurations and inputs, from fixed
    seeds (the same in the parent and in the rehearsal's workers)."""
    T, dt = LTI_CON_T, 1.0 / 32.0
    qp = P.condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    rng = np.random.default_rng(9)
    return dict(
        dsqp=P.DeviceSQP(sqp_iters=4, device=DEVICE, **SQP_KW),
        csqp=make_csqp(P, 4),
        qqp=P.quantize(P.condense_double_integrator(T=50)),
        qcqp=P.quantize_constrained(P.constrain_states(
            qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
            F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0),
        x_rti=torch.as_tensor(rti_states(rng, RTI_BATCH), dtype=torch.float32, device=DEVICE),
        x_con=torch.as_tensor(con_states(rng, CON_BATCH), dtype=torch.float32, device=DEVICE),
        x_lti=lti_states(rng, LTI_BATCH),
        x_lti_con=np.stack([rng.uniform(-1.5, 1.5, CON_BATCH),
                            rng.uniform(-0.2, 0.2, CON_BATCH)], -1),
    )


def sharded_solves(torch, P, mesh, pr):
    """The tier's main path on ``mesh``: DeviceSQP and DeviceConstrainedSQP
    sharded_solve_words (on this rank's shards), ShardedPGD and
    ShardedConstrainedPGD solve(), FusedPGD.dp_sharded.  Returns global
    results on the host and, per solve, its wall ms and its K10 launches."""
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.parallel import ShardedConstrainedPGD, ShardedPGD
    from pint_tpu_torch.parallel.mesh import shard, unshard

    out, wall, k10 = {}, {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        before = K.launch_counts()["pgd_matvec_cols"]
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        k10[name] = K.launch_counts()["pgd_matvec_cols"] - before
        return res

    d, c = pr["dsqp"], pr["csqp"]
    w = run("device_sqp", lambda: d.sharded_solve_words(mesh)(
        shard(d.init_words(RTI_BATCH), mesh, ("dp", "tp")), shard(pr["x_rti"], mesh, ("dp", None))))
    out["dsqp"] = unshard(w, mesh, ("dp", "tp")).cpu()
    out["dsqp_block"] = w                       # this rank's block, on the card
    w, lam = run("device_constrained", lambda: c.sharded_solve_words(mesh)(
        shard(c.init_words(CON_BATCH), mesh, ("dp", "tp")), shard(pr["x_con"], mesh, ("dp", None))))
    out["dcon_words"], out["dcon_lam_local"] = unshard(w, mesh, ("dp", "tp")).cpu(), lam.cpu()
    w, _, res = run("sharded_pgd", lambda: ShardedPGD(pr["qqp"], mesh, iters=15).solve(pr["x_lti"]))
    out["pgd"], out["pgd_residual"] = w.cpu(), res
    w, _, lam = run("sharded_constrained_pgd", lambda: ShardedConstrainedPGD(
        pr["qcqp"], mesh, outer=LTI_CON_OUTER, inners=LTI_CON_INNERS).solve(pr["x_lti_con"]))
    out["cpgd_words"], out["cpgd_lam"] = w.cpu(), lam.cpu()
    fp = P.FusedPGD(pr["qqp"], iters=15, device=DEVICE)
    g = torch.as_tensor(pr["qqp"].g_lane_fixed(pr["x_lti"]), device=DEVICE)
    w = run("fused_dp_sharded", lambda: fp.dp_sharded(mesh)(
        shard(fp.init_words(LTI_BATCH), mesh, ("dp", None)), shard(g, mesh, ("dp", None))))
    out["fused_dp"] = unshard(w, mesh, ("dp", None)).cpu()
    return out, wall, k10


def phase_world1(torch, P, K, timing):
    """The tier at world size 1 over NCCL: make_mesh(dp=1, tp=1) on the
    card, the four sharded solves and FusedPGD.dp_sharded (the main path:
    counts set to 0 before, read after), each bit-identical to its
    single-device solver.  Returns the single-device results for phase 16."""
    import torch.distributed as dist

    from pint_tpu_torch.parallel import distributed as D
    from pint_tpu_torch.parallel import make_mesh

    pr = tier_problems(torch, P)
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world size 1 on {dist.get_backend()}, not nccl")
        mesh = make_mesh(dp=1, tp=1)            # the reference's call: no device
        if mesh.device.type != "cuda":
            raise AssertionError(f"make_mesh with no device built on {mesh.device}")
        K.reset_launch_counts()                 # the tier's main path starts here
        got, wall, _ = sharded_solves(torch, P, mesh, pr)
        counts = K.launch_counts()              # and ends here
        d, c = pr["dsqp"], pr["csqp"]
        # warm solves, sharded and single-device in turns whose order
        # alternates (the host is shared; a tp == 1 program runs the same
        # iteration as solve_words, so the gap is the reading's spread)
        calls = {
            "device_sqp": (lambda: d.sharded_solve_words(mesh)(d.init_words(RTI_BATCH),
                                                               pr["x_rti"]),
                           lambda: d.solve_words(d.init_words(RTI_BATCH), pr["x_rti"])),
            "device_constrained": (lambda: c.sharded_solve_words(mesh)(c.init_words(CON_BATCH),
                                                                       pr["x_con"]),
                                   lambda: c.solve_words(c.init_words(CON_BATCH), pr["x_con"])),
        }
        turns = {k: ([], []) for k in calls}
        for t in range(6):
            for k, fns in calls.items():
                for i in ((0, 1) if t % 2 == 0 else (1, 0)):
                    turns[k][i].extend(timing.host_ms(fns[i], reps=1))
        warm = {k: median(v[0]) for k, v in turns.items()}
        single_ms = {k: median(v[1]) for k, v in turns.items()}
    finally:
        dist.destroy_process_group()
    for name in ("lipq", "pgd_hqt", "pen", "alm", "fused_pgd"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the sharded solves")
    ref = {"dsqp": d.solve_words(d.init_words(RTI_BATCH), pr["x_rti"]).cpu()}
    w, lam = c.solve_words(c.init_words(CON_BATCH), pr["x_con"])
    ref["dcon_words"], ref["dcon_lam"] = w.cpu(), lam.cpu()
    ref["pgd"] = P.FixedPointPGD(pr["qqp"], iters=15, device=DEVICE).solve(pr["x_lti"])[0].cpu()
    fused = P.FusedPGD(pr["qqp"], iters=15, device=DEVICE)
    ref["fused"] = fused.solve(pr["x_lti"])[0].cpu()
    w, _, lam = P.ConstrainedPGD(pr["qcqp"], outer=LTI_CON_OUTER, inners=LTI_CON_INNERS,
                                 device=DEVICE).solve(pr["x_lti_con"])
    ref["cpgd_words"], ref["cpgd_lam"] = w.cpu(), lam.cpu()
    for key, mine, theirs in (("dsqp", "dsqp", "dsqp"), ("dcon words", "dcon_words", "dcon_words"),
                              ("dcon lam", "dcon_lam_local", "dcon_lam"),
                              ("ShardedPGD vs FixedPointPGD", "pgd", "pgd"),
                              ("ShardedPGD vs FusedPGD", "pgd", "fused"),
                              ("ShardedConstrainedPGD words", "cpgd_words", "cpgd_words"),
                              ("ShardedConstrainedPGD lam", "cpgd_lam", "cpgd_lam"),
                              ("FusedPGD.dp_sharded", "fused_dp", "fused")):
        if not torch.equal(got[mine], ref[theirs]):
            raise AssertionError(f"world size 1: {key} differs from the single-device solve")
    rec = dict(backend="nccl", first_call_ms=wall, sharded_ms=warm, single_ms=single_ms,
               readings_ms={k: dict(sharded=v[0], single=v[1]) for k, v in turns.items()},
               launches={k: counts[k] for k in ("lipq", "pgd_hqt", "pen", "alm", "fused_pgd")})
    say(f"world size 1 (nccl), mesh dp=1 tp=1: DeviceSQP 4x30 and DeviceConstrainedSQP "
        f"4x(3x30) sharded_solve_words bit-identical to solve_words (words, lam), ShardedPGD "
        f"to FixedPointPGD and FusedPGD, ShardedConstrainedPGD to ConstrainedPGD (K7), "
        f"dp_sharded to solve_words; first calls ms {json.dumps(wall)} (NCCL set-up "
        f"included); warm medians of 6, in turns: sharded ms {json.dumps(warm)}, single-device ms "
        f"{json.dumps(single_ms)}")
    return rec, ref


REHEARSAL_TIMEOUT_S = 300


def rehearsal_worker(rank, port, out_dir):
    """One rank of phase 16: gloo over CUDA tensors, mesh dp=1 tp=2 on the
    one card.  Writes its results, its launch counts and its wall times."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("rehearsal worker: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    import pint_tpu_torch as P
    from pint_tpu_torch.models.dynamics import CONTROL_LAYOUT, unpack_controls
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.parallel import distributed as D
    from pint_tpu_torch.parallel import make_mesh
    from pint_tpu_torch.utils.checkpoint import load_sharded, save_sharded

    K.library()                                 # built by the parent: same sources
    D.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(dp=1, tp=2, device=DEVICE)
        pr = tier_problems(torch, P)
        d = pr["dsqp"]
        # D4 needs every tp rank to quantize identically: a checksum of one
        # K3 slab, summed and maxed over the ranks (CPU tensors, gloo)
        lanes0 = unpack_controls(d.init_words(RTI_BATCH))
        hqt = d._condense(pr["x_rti"], lanes0)[0]
        w8 = torch.arange(1, hqt.numel() + 1, device=DEVICE, dtype=torch.int64) % 1000003
        ck = torch.tensor([float((hqt.reshape(-1).to(torch.int64) * w8).sum().item())],
                          dtype=torch.float64)
        ck_sum, ck_max = ck.clone(), ck.clone()
        dist.all_reduce(ck_sum)
        dist.all_reduce(ck_max, op=dist.ReduceOp.MAX)
        if ck_sum.item() != 2 * ck_max.item():
            raise AssertionError(f"rank {rank}: K3's hqt differs between the tp ranks")
        K.reset_launch_counts()                 # the rehearsal's main path starts here
        got, wall, k10 = sharded_solves(torch, P, mesh, pr)
        counts = K.launch_counts()              # and ends here
        # each rank saves its own block of the plan, then every rank loads
        # the rows it holds under ("dp", None): the whole plan at dp = 1
        prefix = str(Path(out_dir) / "dsqp")
        save_sharded(prefix, P.PackedArray(got.pop("dsqp_block"), CONTROL_LAYOUT), mesh,
                     ("dp", "tp"))
        dist.barrier()
        back, widths = load_sharded(prefix, mesh, ("dp", None))
        if (widths != CONTROL_LAYOUT.widths or back.device.type != mesh.device.type
                or not torch.equal(back.cpu(), got["dsqp"])):
            raise AssertionError(f"rank {rank}: load_sharded of the saved blocks differs "
                                 "from the joined plan")
    finally:
        dist.destroy_process_group()
    np.savez(Path(out_dir) / f"rank{rank}.npz",
             **{k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in got.items()})
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        dict(wall_ms=wall, k10=k10, counts=counts, r_tp=mesh.r_tp)))
    print(f"rehearsal rank {rank} OK", flush=True)


def phase_rehearsal(torch, ref):
    """Two ranks on the one card (dp=1, tp=2; gloo carries the collectives
    of CUDA tensors through the host, since NCCL refuses two ranks on one
    device): the sharded solves, joined, equal the one-process results, and
    so does ``load_full`` of the blocks the ranks saved with
    ``save_sharded``."""
    import tempfile

    from pint_tpu_torch.convert import words_to_numpy
    from pint_tpu_torch.utils.checkpoint import load_full

    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--rehearsal-rank", str(r), str(port), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        try:
            for r, p in enumerate(procs):
                outs.append(p.communicate(timeout=REHEARSAL_TIMEOUT_S)[0])
                if p.returncode or f"rehearsal rank {r} OK" not in outs[-1]:
                    raise AssertionError(f"rehearsal rank {r} failed ({p.returncode}):\n"
                                         f"{outs[-1][-4000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        res = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(2)]
        meta = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(2)]
        ckpt_files = sorted(p.name for p in Path(tmp).glob("dsqp.proc*.npz"))
        ckpt_full, ckpt_widths = load_full(str(Path(tmp) / "dsqp"))
    if ckpt_files != ["dsqp.proc0.npz", "dsqp.proc1.npz"] or ckpt_widths != (8, 8, 8, 8):
        raise AssertionError(f"rehearsal checkpoint: files {ckpt_files}, widths {ckpt_widths}")
    if not np.array_equal(ckpt_full, words_to_numpy(ref["dsqp"])):
        raise AssertionError("rehearsal checkpoint: load_full of the ranks' files differs "
                             "from the one-process solve")
    for r, m in enumerate(meta):
        for name in ("device_sqp", "device_constrained"):
            if m["k10"][name] < 1:
                raise AssertionError(f"rehearsal rank {r}: K10 never launched in {name}")
    for r, o in enumerate(res):
        for key, theirs in (("dsqp", "dsqp"), ("dcon_words", "dcon_words"),
                            ("dcon_lam_local", "dcon_lam"), ("pgd", "pgd"),
                            ("cpgd_words", "cpgd_words"), ("cpgd_lam", "cpgd_lam"),
                            ("fused_dp", "fused")):
            if not np.array_equal(o[key], ref[theirs].numpy()):
                raise AssertionError(f"rehearsal rank {r}: {key} differs from the "
                                     "one-process solve")
    rec = dict(transport="gloo over CUDA tensors, 2 ranks on one card",
               wall_ms=[m["wall_ms"] for m in meta], k10_launches=[m["k10"] for m in meta],
               launches=sum(m["counts"]["pgd_matvec_cols"] for m in meta))
    say(f"rehearsal dp=1 tp=2 (gloo over CUDA tensors through the host, both ranks on one "
        f"card; not a rate of the tier): joined words and lam bit-identical to the "
        f"one-process solves, K3 slabs equal across ranks; each rank's saved block of the "
        f"DeviceSQP plan reloads onto ('dp', None) and load_full of {ckpt_files} equals the "
        f"one-process words; K10 launches per solve "
        f"{json.dumps(rec['k10_launches'])}; wall ms per rank {json.dumps(rec['wall_ms'])}")
    return rec


def main():
    if not (ROOT / "pint_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: pint_tpu_torch/ is not beside this script")
    sys.path.insert(0, str(ROOT))
    import torch

    smi = phase_device(torch)
    import pint_tpu_torch as P
    from pint_tpu_torch.ops import kernels as K
    from pint_tpu_torch.utils import timing

    if ROOT not in Path(P.__file__).resolve().parents:
        raise SystemExit(f"chip_smoke.py: imported {P.__file__}, not this checkout")
    ptxas_registers = phase_build(K)
    phase_substrate(torch, P)
    swar_launches = phase_packed_flow(torch, P, K)
    headline, swar_times = phase_headline(torch, P)
    k2 = phase_k2(torch, P, timing)
    k3, k4 = phase_k3_k4(torch, P, K, timing)
    k6, k5 = phase_k6_k5(torch, P, timing)
    k7 = phase_k7(torch, P, K, timing)
    mpc = phase_mpc(torch, P, K)
    rti = phase_rti(torch, P, K)
    crti = phase_crti(torch, P, K)
    counts = K.launch_counts()                  # serving path ends here
    for name in ("fused_pgd", "pgd_hqt", "lipq", "pen", "alm"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the serving path")
    flagship = phase_flagship(torch, P, timing)
    con_flagship = phase_con_flagship(torch, P, timing)
    k2p = phase_k2p(torch, P, K, timing)
    k10 = phase_k10(torch, P, timing)
    world1, single = phase_world1(torch, P, K, timing)
    rehearsal = phase_rehearsal(torch, single)
    long = phase_long(torch, P, K)
    long_kernels = phase_long_kernels(torch, P, timing)
    wide, wide_path = phase_wide(torch, P, K, timing)
    rollouts = phase_rollouts(torch, P, timing)
    controller = phase_controller(torch, P, K, timing)
    models = phase_models(torch, P, K, timing)
    forms = phase_forms(torch, P)
    t0 = time.perf_counter()
    sqp_host = phase_sqp_host(torch, P, timing)
    t1 = time.perf_counter()
    lti, lti_k2 = phase_lti_controllers(torch, P, K, timing)
    t2 = time.perf_counter()
    planners = phase_planners(torch, P, timing)
    t3 = time.perf_counter()
    swingup = phase_swingup(torch, P)
    t4 = time.perf_counter()
    native = phase_native(torch, P, swar_times["swar_binop"][2], smi)
    t5 = time.perf_counter()
    ckpt = phase_checkpoint(torch, P, K, timing)
    t6 = time.perf_counter()
    chain = phase_chain(torch, P, timing)
    reduce = phase_reduce(torch, P, timing)
    rows = phase_stack(torch, P, timing)
    phase_sec = dict(sqp_host=t1 - t0, lti_controllers=t2 - t1, planners=t3 - t2,
                     swingup=t4 - t3, native=t5 - t4, checkpoint=t6 - t5)
    say(f"phases 23-26: {phase_sec['sqp_host']:.1f} s, {phase_sec['lti_controllers']:.1f} s, "
        f"{phase_sec['planners']:.1f} s, {phase_sec['swingup']:.1f} s ({t4 - t0:.1f} s in all); "
        f"phases 27-28: {phase_sec['native']:.1f} s, {phase_sec['checkpoint']:.1f} s")

    from pint_tpu_torch.utils.profiling import bound_ms, kernel_cost

    lay32, lay64 = P.PackedLayout(8, 8, 8, 8), P.PackedLayout(*([8] * 8))
    swar = {   # name: (id, TPU kernel, layout, kind, words, op)
        "swar_binop": ("K1", "pint_tpu/ops/pallas.py:148", lay32, "binop", N_HEADLINE,
                       "add_unsigned_saturate"),
        "swar_shift": ("K9", "pint_tpu/ops/pallas.py:306", lay32, "shift", N_HEADLINE,
                       "shift_left"),
        "swar_sat_accum": ("K8", "pint_tpu/ops/pallas.py:407", lay32, "sat_accum",
                           N_HEADLINE, "unsigned"),
        "swar_binop_pair": ("K11a", "pint_tpu/ops/pallas.py:222", lay64, "binop", N_U64,
                            "add_unsigned_saturate"),
        "swar_shift_pair": ("K11b", "pint_tpu/ops/pallas.py:341", lay64, "shift", N_U64,
                            "shift_left"),
        "swar_sat_accum_pair": ("K11c", "pint_tpu/ops/pallas.py:469", lay64, "sat_accum",
                                N_U64, "unsigned"),
    }
    no_library = {
        "swar": "none: no PyTorch call adds, shifts or saturates packed lanes (the raw "
                "int32 add is the headline's yardstick, not the same function)",
        "loop": "none: no PyTorch call runs the iterated fixed-point loop",
        "power": "none: no PyTorch call runs a power iteration with an int8 quantization",
        "matvec": "none: PyTorch's batched products take no int8 slab with int32 lanes "
                  "on CUDA in one call",
        "chain": "none: no PyTorch call runs a rollout, its linearization and the "
                 "propagator recursion",
        "reduce": "none: no PyTorch call sums a product over a triangle's live steps; "
                  "sym_ms is the torch _reduce_sym it replaces",
        "stack": "none: no PyTorch call writes a product batch-last in one pass; "
                 "einsum_ms is the two einsums it replaces",
    }
    kernels = []

    def entry(name, source, replaces, launches, rec, cost, library):
        b_ms, b_by = bound_ms(cost)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=launches,
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], queued_ms=rec["queued_ms"],
            plain_ms=rec["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            share_of_bound=b_ms / rec["queued_ms"], library_ms=None,
            library=no_library[library]))

    for name, (kid, line, lay, kind, n, op) in swar.items():
        ms, pms, qms = swar_times[name]
        entry(f"{name} ({kid})", "pint_tpu_torch/csrc/swar.cu", line, swar_launches[name],
              dict(max_abs_err=0.0, ms=ms, plain_ms=pms, queued_ms=qms),
              kernel_cost("swar", layout=lay, kind=kind, n=n, op=op,
                          steps=ACCUM_STEPS, pair=name.endswith("pair")), "swar")
    k2_main = dict(k2["iters15_momentum0"],
                   max_abs_err=max(r["max_abs_err"] for r in k2.values()))
    entry("fused_pgd (K2)", "pint_tpu_torch/csrc/fused_pgd.cu", "pint_tpu/mpc/fused.py:119",
          counts["fused_pgd"] + lti_k2, k2_main,
          kernel_cost("fused_pgd", B=LTI_BATCH, Tp=k2_main["Tp"], iters=k2_main["iters"]),
          "loop")
    kernels[-1]["launches_by_path"] = {"serving (MPCService ticks)": counts["fused_pgd"],
                                       "LTI controller ticks (phase 24)": lti_k2}
    entry("lipq (K3)", "pint_tpu_torch/csrc/lipq.cu", "pint_tpu/mpc/condense_fused.py:77",
          counts["lipq"], k3, kernel_cost("lipq", B=RTI_BATCH, Tm=k3["Tm"],
                                             power_iters=k3["power_iters"]),
          "power")
    entry("pgd_hqt (K4, words entry)", "pint_tpu_torch/csrc/pgd_hqt.cu",
          "pint_tpu/mpc/fused_alm.py:402", counts["pgd_hqt"], k4,
          kernel_cost("pgd_hqt", B=RTI_BATCH, Tp=k4["Tp"], iters=k4["iters"], words=True),
          "loop")
    entry("pen (K6)", "pint_tpu_torch/csrc/pen.cu", "pint_tpu/mpc/condense_fused.py:198",
          counts["pen"], k6,
          kernel_cost("pen", B=CON_BATCH, C=k6["C"], Tm=k6["Tm"],
                      power_iters=k6["power_iters"]), "power")
    entry("alm (K5)", "pint_tpu_torch/csrc/alm.cu", "pint_tpu/mpc/fused_alm.py:335",
          counts["alm"], k5,
          kernel_cost("alm", B=CON_BATCH, Tp=k5["Tp"], Cp=k5["Cp"], outer=k5["outer"],
                      inners=k5["inners"]), "loop")
    entry("alm_shared (K7)", "pint_tpu_torch/csrc/alm.cu", "pint_tpu/mpc/fused_alm.py:176",
          k7["launches"], k7,
          kernel_cost("alm_shared", B=CON_BATCH, Tp=k7["Tp"], Cp=k7["Cp"],
                      outer=LTI_CON_OUTER, inners=LTI_CON_INNERS), "loop")
    lc = {k: r["launches"] for k, r in long.items()}
    sqp_l, con_l = lc[f"device_sqp_T{LONG_T}"], lc[f"device_constrained_T{LONG_T}"]
    sqp_p, con_p = lc[f"device_sqp_T{PAST_T}"], lc[f"device_constrained_T{PAST_T}"]
    con_k6, con_2 = lc[f"device_constrained_T{PEN_T}"], lc[f"device_constrained_T{TWO_ROW_T}"]
    for key, name, kernel, source, line, launches in (
            ("lipq (K3)", "lipq (K3, T=128, long form, rows in registers)", "lipq", "lipq.cu",
             "condense_fused.py:77", sqp_l["lipq"] + con_l["lipq"]),
            ("pen (K6)", "pen (K6, T=128, cluster kernel)", "pen", "pen.cu",
             "condense_fused.py:198", con_l["pen"]),
            (f"pen (K6) T={PEN_T}", "pen (K6, T=136, cluster kernel)", "pen", "pen.cu",
             "condense_fused.py:198", con_k6["pen"]),
            (f"pen (K6) T={TWO_ROW_T}", "pen (K6, T=20 two rows, warp kernel)", "pen",
             "pen.cu", "condense_fused.py:198", con_2["pen"]),
            (f"pgd_hqt (K4) T={LONG_T}", "pgd_hqt (K4, T=128, cluster kernel)", "pgd_hqt",
             "alm.cu", "fused_alm.py:402", sqp_l["pgd_hqt"]),
            (f"alm (K5) T={LONG_T}", "alm (K5, T=128, cluster kernel)", "alm", "alm.cu",
             "fused_alm.py:335", con_l["alm"]),
            (f"pgd_hqt (K4) T={PAST_T}", "pgd_hqt (K4, T=144, cluster kernel)", "pgd_hqt",
             "alm.cu", "fused_alm.py:402", sqp_p["pgd_hqt"]),
            (f"alm (K5) T={PAST_T}", "alm (K5, T=144, cluster kernel)", "alm", "alm.cu",
             "fused_alm.py:335", con_p["alm"]),
            (f"alm (K5) T={LONG_T} 1x0", "alm (K5, T=128, cluster kernel, 1 x 0: staging "
             "and write-back alone)", "alm", "alm.cu", "fused_alm.py:335", con_l["alm"]),
            (f"pgd_hqt (K4) Tp={K4_WIDEST}", f"pgd_hqt (K4, Tp={K4_WIDEST}, cluster kernel, "
             "random operands)", "pgd_hqt", "alm.cu", "fused_alm.py:402",
             sqp_l["pgd_hqt"])):
        r = long_kernels[key]
        shape = {k: r[k] for k in ("B", "Tm", "Tp", "Cp", "C", "iters", "power_iters",
                                   "outer", "inners") if k in r}
        if kernel == "pgd_hqt":
            shape["words"] = True
        entry(name, f"pint_tpu_torch/csrc/{source}", f"pint_tpu/mpc/{line}", launches, r,
              kernel_cost(kernel, **shape), "power" if kernel in ("lipq", "pen") else "loop")
    k2p_main = k2p["iters15"]
    entry("fused_pgd_packed (K2p)", "pint_tpu_torch/csrc/fused_pgd.cu",
          "pint_tpu/mpc/fused.py:136", k2p["launches"],
          dict(k2p_main, ms=k2p_main["single_call_ms"], queued_ms=k2p_main["ms"]),
          kernel_cost("fused_pgd", B=LTI_BATCH, Tp=k2p_main["Tp"], iters=k2p_main["iters"],
                      packed=True), "loop")
    k10_main = k10["tp2_sqp"]
    entry("pgd_matvec_cols (K10)", "pint_tpu_torch/csrc/matvec_cols.cu",
          "pint_tpu/mpc/fused_alm.py:429", rehearsal["launches"],
          dict(k10_main, ms=k10_main["single_call_ms"], queued_ms=k10_main["ms"]),
          kernel_cost("pgd_matvec_cols", B=RTI_BATCH, K=k10_main["K"],
                      rows=k10_main["rows"]), "matvec")
    for key, r in wide.items():
        kernel = key.split(" ")[0]
        shape = {k: r[k] for k in ("B", "Tp", "Cp", "iters", "outer", "inners", "packed")
                 if k in r}
        entry(f"{key} (wide form)", "pint_tpu_torch/csrc/" +
              ("alm.cu" if kernel == "alm_shared" else "fused_pgd.cu"),
              {"fused_pgd": "pint_tpu/mpc/fused.py:119",
               "fused_pgd_packed": "pint_tpu/mpc/fused.py:136",
               "alm_shared": "pint_tpu/mpc/fused_alm.py:176"}[kernel],
              wide_path[kernel], r,
              kernel_cost("fused_pgd" if kernel.startswith("fused_pgd") else kernel,
                          **shape), "loop")
    serving_chain = rti["chain_launches"] + crti["chain_launches"]
    long_chain = (long[f"device_sqp_T{LONG_T}"]["chain_launches"]
                  + long[f"device_constrained_T{LONG_T}"]["chain_launches"])
    for key, launches, paths in (
            ("T=32 B=4096", serving_chain, "serving (RTIService, ConstrainedRTIService ticks)"),
            ("T=32 B=16384", serving_chain, "serving at T=32 (the B=4096 ticks: the kernel "
             "and its main path are the same at T=32, only the timed batch differs)"),
            (f"T={LONG_T} B={LONG_BATCH}", long_chain, f"long horizon T={LONG_T} solves "
             "(phase 17)")):
        r = chain[key]
        entry(f"propagate (chain, {key})", "pint_tpu_torch/csrc/propagate.cu",
              "none: the reference's chain is XLA jnp (pint_tpu/mpc/device_sqp.py)",
              launches, r, kernel_cost("propagate", B=r["B"], T=r["T"]), "chain")
        kernels[-1]["launches_by_path"] = {paths: launches}
    serving_reduce = rti["reduce_launches"] + crti["reduce_launches"]
    long_reduce = (long[f"device_sqp_T{LONG_T}"]["reduce_launches"]
                   + long[f"device_constrained_T{LONG_T}"]["reduce_launches"])
    for key, launches, paths in (
            ("T=32 B=4096", serving_reduce, "serving (RTIService, ConstrainedRTIService "
             "ticks)"),
            ("T=32 B=16384", serving_reduce, "serving at T=32 (the B=4096 ticks: the kernel "
             "and its main path are the same at T=32, only the timed batch differs)"),
            (f"T={LONG_T} B={LONG_BATCH}", long_reduce, f"long horizon T={LONG_T} solves "
             "(phase 17)")):
        r = reduce[key]
        entry(f"reduce ({key})", "pint_tpu_torch/csrc/reduce.cu",
              "none: the reference's reduce is XLA jnp (pint_tpu/mpc/device_sqp.py)",
              launches, r, kernel_cost("reduce", B=r["B"], T=r["T"], n=3, m=2), "reduce")
        kernels[-1]["launches_by_path"] = {paths: launches}
        kernels[-1]["sym_ms"] = r["sym_ms"]
    long_rows = long[f"device_constrained_T{LONG_T}"]["stack_launches"]
    for key, launches, paths in (
            ("n=3 T=32 B=4096", crti["stack_launches"], "serving (ConstrainedRTIService "
             "ticks)"),
            ("n=3 T=32 B=16384", crti["stack_launches"], "serving at T=32 (the B=4096 "
             "ticks: the kernel and its main path are the same at T=32, only the timed "
             "batch differs)"),
            (f"n=3 T={LONG_T} B={LONG_BATCH}", long_rows, f"long horizon T={LONG_T} "
             "constrained solve (phase 17)"),
            ("n=6 T=16 B=4096", models["quadrotor_device_constrained_T16"]["stack_launches"],
             "the quadrotor's DeviceConstrainedSQP solve (phase 21)")):
        r = rows[key]
        entry(f"stack (constraint rows, {key})", "pint_tpu_torch/csrc/stack.cu",
              "none: the reference's stacking is XLA jnp "
              "(pint_tpu/mpc/device_constrained.py)", launches, r,
              kernel_cost("stack", B=r["B"], T=r["T"], n=r["n"], Tm=r["Tm"], Cs=r["Cs"]),
              "stack")
        kernels[-1]["launches_by_path"] = {paths: launches}
        kernels[-1]["einsum_ms"] = r["einsum_ms"]
    name = torch.cuda.get_device_name(0)
    say(json.dumps({"headline": headline}))
    say(json.dumps({"serving": {"mpc": mpc, "rti": rti, "crti": crti},
                    "flagship": flagship, "constrained_flagship": con_flagship,
                    "lti_constrained": k7}))
    say(json.dumps({"k2p": k2p, "k10": k10, "world1": world1, "rehearsal": rehearsal,
                    "long_horizon": long, "long_horizon_kernels": long_kernels}))
    say(json.dumps({"wide": wide, "rollouts": rollouts, "controller": controller,
                    "models": models, "forms": forms}))
    say(json.dumps({"sqp_host": sqp_host, "lti_controllers": lti, "planners": planners,
                    "swingup": swingup, "native": native, "checkpoint": ckpt, "chain": chain,
                    "reduce": reduce, "stack": rows, "phase_sec": phase_sec}))
    say(json.dumps({"ptxas_registers": ptxas_registers}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    if sys.argv[1:2] == ["--rehearsal-rank"]:
        rehearsal_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
