"""Port parity: the multi-device tier (``pint_tpu_torch.parallel``, the
column-sharded inners, the sharded SQP solves, K10's plain version) against
pint_tpu's, on real gloo process worlds.

Two worlds are spawned once for the module, as subprocesses: 2 ranks
(meshes dp x tp = 2x1 and 1x2) and 4 ranks (2x2 and 1x4).  Each rank
imports only torch, numpy and the port, takes its inputs from .npy files,
runs every case on each of its meshes and writes its results back; the
single-device references of D4 are computed in the worker too, under the
same ``torch.set_num_threads(1)``.  Meanwhile this process computes JAX's
side on conftest's 8-device virtual mesh, with JAX's Pallas kernels in
interpret mode.

Tolerances: the integer solvers and the column inners given identical
quantized operands are bit-identical (words and multipliers); ShardedPGD's
f32 residual within rtol 1e-6 (it is summed in another order); the sharded
SQP solves bit-identical to the port's own ``solve_words`` (D4) and, against
JAX's sharded solves, at cost parity (rtol 0.01, atol 1e-4) and, for the
constrained one, violation parity (atol 5e-3) -- tests/test_device_sqp.py's
bounds, since the f32 condensations differ in the last ulps.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pint_tpu.mpc import DeviceConstrainedSQP as JDeviceConstrainedSQP
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu.mpc import QuantizedSQP
from pint_tpu.models.quadrotor import PlanarQuadrotor as JPlanarQuadrotor
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.mpc.accelerated import AcceleratedPGD as JAccelerated
from pint_tpu.mpc.constrained import constrain_states as j_constrain
from pint_tpu.mpc.constrained import quantize_constrained as j_quantize_constrained
from pint_tpu.mpc.fused_alm import pgd_matvec_cols as j_matvec
from pint_tpu.mpc.ltv import _pgd_batched_h_cols as j_pgd_cols
from pint_tpu.mpc.ltv import _pgd_batched_h_cols_hqt as j_pgd_cols_hqt
from pint_tpu.mpc.sqp_constrained import _alm_batched_cols as j_alm_cols
from pint_tpu.mpc.sqp_constrained import _alm_batched_cols_hqt as j_alm_cols_hqt
from pint_tpu.parallel import ShardedConstrainedPGD as JShardedConstrained
from pint_tpu.parallel import ShardedPGD as JShardedPGD
from pint_tpu.parallel import make_mesh as j_make_mesh
from pint_tpu import PackedArray as JPackedArray
from pint_tpu import PackedLayout as JPackedLayout
from pint_tpu.utils.checkpoint import load_full as j_load_full
from pint_tpu.utils.checkpoint import load_sharded as j_load_sharded
from pint_tpu.utils.checkpoint import save_sharded as j_save_sharded
from pint_tpu_torch.convert import device_constrained_config, device_sqp_config
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc.fused_alm import pgd_matvec_cols, pgd_matvec_cols_plain
from pint_tpu_torch.mpc.ltv import _pgd_batched_h
from pint_tpu_torch.mpc.sqp_constrained import _Y_SHIFT, _alm_batched
from pint_tpu_torch.parallel import distributed as D
from pint_tpu_torch.parallel import make_mesh

MESHES = [(2, 1), (1, 2), (2, 2), (1, 4)]
WORLD_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
IDS = [f"dp{d}tp{t}" for d, t in MESHES]
TIMEOUT_S = 180
B = 16                                   # every case's global batch
SQP_KW = dict(horizon=8, sqp_iters=3, pgd_iters=20, Q=[1.0, 1.0, 0.005],
              R=[0.005, 0.005], qf_scale=60.0, x_ref=[0.2, 0.1, 0.0])
CON_SQP_KW = dict(horizon=8, sqp_iters=3, pgd_iters=12, x_ref=[1.0, 0.0, 0.0])
CON_KW = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=2)
PGD_ITERS, MOM_ITERS, ALM_OUTER, ALM_INNERS = 25, 15, 6, 20
LTI_CON_T = 48
# the planar quadrotor (n 6, m 2: Tm = 32 lanes over 8 words a problem) at
# tests/test_quadrotor_device.py's configuration, on the 2-rank world
QUAD_KW = dict(horizon=16, sqp_iters=4, pgd_iters=30, Q=[4.0, 4.0, 1.0, 0.2, 0.2, 0.1],
               R=[0.05, 0.05], qf_scale=20.0, x_ref=[0.0] * 6)
QUAD_MESHES = [(2, 1), (1, 2)]


def _sqp_kw(kw):
    """The solver keywords with the diagonal weights as matrices."""
    out = dict(kw)
    for k in ("Q", "R"):
        if k in out:
            out[k] = np.diag(out[k])
    out["x_ref"] = np.asarray(out["x_ref"])
    return out


WORKER = textwrap.dedent(
    """
    import ast
    import os
    import sys
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(1)
    rank, world, init, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    cfg = ast.literal_eval((io / "config.txt").read_text())

    from pint_tpu_torch import mpc as M
    from pint_tpu_torch.models import PlanarQuadrotor
    from pint_tpu_torch.mpc.ltv import _pgd_batched_h_cols, _pgd_batched_h_cols_hqt
    from pint_tpu_torch.mpc.sqp_constrained import (
        _Y_SHIFT, _alm_batched_cols, _alm_batched_cols_hqt)
    from pint_tpu_torch.parallel import (
        ShardedConstrainedPGD, ShardedPGD, distributed as D, host_local_mesh, make_mesh)
    from pint_tpu_torch.parallel.mesh import psum, shard, unshard
    from pint_tpu_torch import PackedArray, PackedLayout
    from pint_tpu_torch.convert import words_from_numpy
    from pint_tpu_torch.utils.checkpoint import load_full, load_sharded, save_sharded

    D.initialize(init, world, rank, backend="gloo")
    inp = dict(np.load(io / "inputs.npz"))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    out = {"rate": np.float64(D.aggregate_rate(1.5 * (rank + 1))),
           "multi": np.bool_(D.is_multi_process()),
           "info": np.array([D.process_info()["process_index"],
                             D.process_info()["process_count"]])}

    def sqp_kw(kw):
        kw = dict(kw)
        for k in ("Q", "R"):
            if k in kw:
                kw[k] = np.diag(kw[k])
        kw["x_ref"] = np.asarray(kw["x_ref"])
        return kw

    qqp = M.quantize(M.condense_double_integrator(T=50))
    T, dt = cfg["LTI_CON_T"], 1.0 / 32.0
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    qcqp = M.quantize_constrained(M.constrain_states(
        M.condense_double_integrator(T=T, dt=dt, q_pos=4.0),
        np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)), None,
        F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0)
    dev = M.DeviceSQP(device="cpu", **sqp_kw(cfg["SQP_KW"]))
    devc = M.DeviceConstrainedSQP(M.DeviceSQP(device="cpu", **sqp_kw(cfg["CON_SQP_KW"])),
                                  **cfg["CON_KW"])
    devc_word = M.DeviceConstrainedSQP(
        M.DeviceSQP(use_kernels=False, device="cpu", **sqp_kw(cfg["CON_SQP_KW"])),
        **cfg["CON_KW"])
    devq = M.DeviceSQP(model=PlanarQuadrotor(), device="cpu", **sqp_kw(cfg["QUAD_KW"]))
    dev_word = M.DeviceSQP(fused=False, device="cpu", **sqp_kw(cfg["SQP_KW"]))
    assert dev_word.forms["inner"] == "pgd_batched_h"
    B = cfg["B"]
    lay = PackedLayout(8, 8, 8, 8)
    ck_words = words_from_numpy(inp["ck_words"], device="cpu")
    ck_vals = t["ck_vals"]

    def barrier():
        torch.distributed.barrier()

    def message(fn):
        try:
            fn()
            return ""
        except ValueError as e:
            return str(e)

    prev_tag = None
    if rank == 0:      # the single-device references (D4), same thread count
        out["ref/dsqp"] = dev.solve_words(dev.init_words(B), t["sqp_x0"]).numpy()
        if world == 2:
            out["ref/qsqp"] = devq.solve_words(devq.init_words(B), t["quad_x0"]).numpy()
        w, lam = devc.solve_words(devc.init_words(B), t["con_x0"])
        out["ref/dcon_words"], out["ref/dcon_lam"] = w.numpy(), lam.numpy()

    for dp, tp in cfg["WORLD_MESHES"][world]:
        mesh = make_mesh(dp=dp, tp=tp, device="cpu")
        tag = f"dp{dp}tp{tp}"
        mine = f"{tag}/r{rank}"
        out[mine + "/coords"] = np.array([mesh.r_dp, mesh.r_tp])

        w, u, res = ShardedPGD(qqp, mesh, iters=cfg["PGD_ITERS"]).solve(inp["lti_x0"])
        out[tag + "/pgd_words"], out[tag + "/pgd_res"] = w.numpy(), np.float64(res)
        sp = ShardedPGD(qqp, mesh, iters=cfg["MOM_ITERS"], momentum=True)
        w, _, _ = sp.solve(inp["lti_x0"])
        out[tag + "/mom_words"] = w.numpy()
        scp = ShardedConstrainedPGD(qcqp, mesh, outer=cfg["ALM_OUTER"], inners=cfg["ALM_INNERS"])
        w, _, lam = scp.solve(inp["lti_con_x0"])
        out[tag + "/cpgd_words"], out[tag + "/cpgd_lam"] = w.numpy(), lam.numpy()
        out[mine + "/tp"] = np.array([sp.tp, scp.tp])
        out[mine + "/Hq_dev"], out[mine + "/lower_words"] = sp.Hq_dev.numpy(), sp.lower_words.numpy()

        fp = M.FusedPGD(qqp, iters=cfg["PGD_ITERS"], device="cpu")
        g = torch.as_tensor(qqp.g_lane_fixed(inp["lti_x0"]))
        wl = fp.dp_sharded(mesh)(shard(fp.init_words(B), mesh, ("dp", None)),
                                 shard(g, mesh, ("dp", None)))
        out[tag + "/fused_dp"] = unshard(wl, mesh, ("dp", None)).numpy()

        # the column inners on identical quantized operands (stored batch
        # first; the rank takes its dp rows, then the kernel orientation)
        def rows(name):
            return shard(t[name], mesh, ("dp", None))

        def vec(name):
            return shard(t[name][:, None], mesh, ("dp", None))[:, 0].contiguous()

        def batch_last(name):
            return rows(name).permute(1, 2, 0).contiguous()

        block = 16 // tp
        kw = dict(iters=cfg["PGD_ITERS"], g_shift=12, group=mesh.tp_group,
                  rank=mesh.r_tp, block=block)
        wd = shard(t["pgd_words"], mesh, ("dp", "tp"))
        gd = shard(t["pgd_g"], mesh, ("dp", "tp"))
        hs = [vec("pgd_hs_num"), vec("pgd_hs_den")]
        hqt_d = batch_last("pgd_hqt")
        w1 = _pgd_batched_h_cols(wd, gd, hqt_d.permute(2, 1, 0), *hs, **kw)
        w2 = _pgd_batched_h_cols_hqt(wd, gd, hqt_d, *hs, **kw)
        out[tag + "/pgd_cols"] = unshard(w1, mesh, ("dp", "tp")).numpy()
        out[tag + "/pgd_cols_hqt"] = unshard(w2, mesh, ("dp", "tp")).numpy()

        akw = dict(outer=cfg["ALM_OUTER"] // 2, inners=cfg["ALM_INNERS"] // 2, g_shift=12,
                   y_shift=_Y_SHIFT, group=mesh.tp_group, rank=mesh.r_tp, block=block)
        rest = [vec("alm_cs_num"), vec("alm_cs_den"), rows("alm_c_off"), rows("alm_lo"),
                rows("alm_hi"), vec("alm_eh_num"), vec("alm_eh_den"), vec("alm_el_num"),
                vec("alm_el_den"), rows("alm_lam")]
        aw = shard(t["alm_words"], mesh, ("dp", "tp"))
        ag = shard(t["alm_g"], mesh, ("dp", "tp"))
        ahqt, asqj, asqc = batch_last("alm_hqt"), batch_last("alm_sqj"), batch_last("alm_sqc")
        hsn, hsd = vec("alm_hs_num"), vec("alm_hs_den")
        w1, l1 = _alm_batched_cols(aw, ag, ahqt.permute(2, 1, 0), hsn, hsd,
                                   asqc.permute(2, 0, 1), *rest, **akw)
        w2, l2 = _alm_batched_cols_hqt(aw, ag, ahqt, hsn, hsd, asqj, *rest, **akw)
        out[tag + "/alm_cols"] = unshard(w1, mesh, ("dp", "tp")).numpy()
        out[tag + "/alm_cols_hqt"] = unshard(w2, mesh, ("dp", "tp")).numpy()
        out[mine + "/alm_cols_lam"] = l1.numpy()
        out[mine + "/alm_cols_hqt_lam"] = l2.numpy()

        # the sharded SQP solves
        prog = dev.sharded_solve_words(mesh)
        assert dev.sharded_solve_words(mesh) is prog
        wl = prog(shard(dev.init_words(B), mesh, ("dp", "tp")), shard(t["sqp_x0"], mesh, ("dp", None)))
        out[tag + "/dsqp"] = unshard(wl, mesh, ("dp", "tp")).numpy()
        for name, solver in (("dcon", devc), ("dcon_word", devc_word)):
            wl, ll = solver.sharded_solve_words(mesh)(
                shard(solver.init_words(B), mesh, ("dp", "tp")), shard(t["con_x0"], mesh, ("dp", None)))
            out[f"{tag}/{name}_words"] = unshard(wl, mesh, ("dp", "tp")).numpy()
            out[f"{mine}/{name}_lam"] = ll.numpy()

        wl = dev_word.sharded_solve_words(mesh)(shard(dev_word.init_words(B), mesh, ("dp", "tp")),
                                                shard(t["sqp_x0"], mesh, ("dp", None)))
        out[tag + "/dsqp_fused_false"] = unshard(wl, mesh, ("dp", "tp")).numpy()

        # checkpoints: this rank's block saved, then loaded back, resharded,
        # from the previous mesh's files and from JAX's; a missing file
        pre = str(io / f"ck_{tag}")
        path = save_sharded(pre + "_plan", PackedArray(shard(ck_words, mesh, ("dp", "tp")), lay),
                            mesh, ("dp", "tp"))
        out[mine + "/ck_path"] = np.array(Path(path).name)
        save_sharded(pre + "_state", shard(ck_vals, mesh, ("dp", None)), mesh, ("dp", None))
        save_sharded(pre + "_half", shard(ck_vals, mesh, ("dp", "tp")), mesh, ("dp", "tp"))
        barrier()
        got, widths = load_sharded(pre + "_plan", mesh, ("dp", "tp"))
        out[mine + "/ck_plan"], out[mine + "/ck_widths"] = got.numpy(), np.array(widths)
        out[mine + "/ck_full"] = load_full(pre + "_plan")[0]
        out[mine + "/ck_reshard"] = load_sharded(pre + "_state", mesh, ("dp", "tp"))[0].numpy()
        out[mine + "/ck_whole"] = load_sharded(pre + "_state", mesh, (None, None))[0].numpy()
        if prev_tag is not None:
            out[mine + "/ck_cross"] = load_sharded(str(io / f"ck_{prev_tag}_plan"), mesh,
                                                   ("dp", "tp"))[0].numpy()
        got, widths = load_sharded(str(io / "jax_plan"), mesh, ("dp", "tp"))
        out[mine + "/ck_jax_plan"], out[mine + "/ck_jax_widths"] = got.numpy(), np.array(widths)
        out[mine + "/ck_jax_state"] = load_sharded(str(io / "jax_state"), mesh,
                                                   ("dp", "tp"))[0].numpy()
        barrier()
        if rank == 0:
            os.remove(f"{pre}_half.proc{world - 1}.npz")
        barrier()
        out[mine + "/ck_missing"] = np.array([
            message(lambda: load_sharded(pre + "_half", mesh, ("dp", "tp"))),
            message(lambda: load_full(pre + "_half"))])
        prev_tag = tag

        if (dp, tp) in cfg["QUAD_MESHES"]:
            wl = devq.sharded_solve_words(mesh)(shard(devq.init_words(B), mesh, ("dp", "tp")),
                                                shard(t["quad_x0"], mesh, ("dp", None)))
            out[tag + "/qsqp"] = unshard(wl, mesh, ("dp", "tp")).numpy()

        bad_dev = M.DeviceSQP(horizon=18, sqp_iters=1, pgd_iters=1, device="cpu")  # n_dec = 36
        bad_con = M.DeviceConstrainedSQP(M.DeviceSQP(horizon=18, sqp_iters=1, pgd_iters=1,
                                                     device="cpu"),
                                         F=[[0.0, 1.0, 0.0]])
        raised = []
        for fn in (lambda: bad_dev.sharded_solve_words(mesh),
                   lambda: bad_con.sharded_solve_words(mesh)):
            try:
                fn()
                raised.append("")
            except ValueError as e:
                raised.append(str(e))
        out[tag + "/bad_tp"] = np.array(raised)

    try:
        make_mesh(dp=world, tp=2, device="cpu")
        out["wrong_world"] = np.array("")
    except ValueError as e:
        out["wrong_world"] = np.array(str(e))
    # two hosts of two ranks in the 4-rank world, one host in the 2-rank one
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    hm = host_local_mesh(tp=2, device="cpu")
    out["host_mesh"] = np.array(list(hm.ranks) + [
        int(psum(torch.tensor([rank + 1]), hm.group).item()), hm.r_dp, hm.r_tp])
    np.savez(io / f"out_w{world}_r{rank}.npz", **out)
    # tear the group down before the interpreter exits: a gloo group left
    # alive can abort the process at exit ("terminate called without an
    # active exception") after its work is done
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank} of {world} OK", flush=True)
    """
)


def _x0_lti(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-3, 3, n), rng.uniform(-1, 1, n)], -1)


def _x0_quad(n, seed):
    return (np.random.default_rng(seed).normal(size=(n, 6)) * 0.2).astype(np.float32)


def _x0_sqp(n, seed, theta=(0.0, 1.0)):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                     rng.uniform(*theta, n)], -1).astype(np.float32)


def _operands():
    """Real quantized operands of one DeviceSQP and one
    DeviceConstrainedSQP condensation (the port's own, on the CPU), and
    warm plans with -128 lanes.  The int8 slabs are stored batch first,
    ``x[b] = slab[..., b]`` (so ``pgd_hqt[b, k, j] = Hq_b[j, k]``)."""
    rng = np.random.default_rng(21)
    dev = DeviceSQP(**_sqp_kw(SQP_KW), device="cpu")
    lanes = rng.integers(-128, 128, (B, dev.n_dec), dtype=np.int32)
    from pint_tpu_torch.models.dynamics import pack_controls

    tl = torch.from_numpy(lanes)
    hqt, g, num, den = dev._condense(torch.from_numpy(_x0_sqp(B, 22)), tl)
    out = dict(pgd_words=pack_controls(tl).numpy(), pgd_g=g.numpy(),
               pgd_hqt=np.ascontiguousarray(hqt.permute(2, 0, 1).numpy()),
               pgd_hs_num=num.numpy(), pgd_hs_den=den.numpy())
    devc = DeviceConstrainedSQP(DeviceSQP(**_sqp_kw(CON_SQP_KW), device="cpu"), **CON_KW)
    lanes = rng.integers(-60, 61, (B, devc.dev.n_dec), dtype=np.int32)
    tl = torch.from_numpy(lanes)
    ops, _ = devc._condense_constrained_dev(torch.from_numpy(_x0_sqp(B, 23, (-np.pi, np.pi))), tl)
    out.update(alm_words=pack_controls(tl).numpy(), alm_g=ops["g_pre"].numpy(),
               alm_lam=rng.integers(0, 500, (B, devc.padded_rows), dtype=np.int32))
    for k in ("hqt", "sqj", "sqc"):      # stored batch-first: (B, ., .)
        out["alm_" + k] = np.ascontiguousarray(ops[k].permute(2, 0, 1).numpy())
    for k in ("hs_num", "hs_den", "cs_num", "cs_den", "eh_num", "eh_den", "el_num",
              "el_den", "c_off"):
        out["alm_" + k] = ops[k].numpy()
    out["alm_lo"], out["alm_hi"] = ops["lo_pre"].numpy(), ops["hi_pre"].numpy()
    return out


def _spawn(io, world):
    repo = pathlib.Path(__file__).resolve().parents[1]
    script = io / "worker.py"
    # rendezvous through a file of this world's own: no port is chosen here
    # and released before rank 0 binds it, where another process could take it
    init = (io / f"rendezvous_w{world}").as_uri()
    env = {"PYTHONPATH": str(repo), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(io), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, str(script), str(r), str(world), init, str(io)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]


def _wait(procs, world):
    """Every rank's output; all ranks are killed when one fails or hangs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
            if p.returncode:
                raise AssertionError(f"a rank of the {world}-rank world failed:\n{outs[-1][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _jax_side(inp):
    """JAX's results on the virtual mesh, keyed like the workers'."""
    res = {}
    qqp = j_quantize(j_condense(T=50))
    T, dt = LTI_CON_T, 1.0 / 32.0
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    qcqp = j_quantize_constrained(j_constrain(
        j_condense(T=T, dt=dt, q_pos=4.0), np.broadcast_to(A, (T, 2, 2)),
        np.broadcast_to(Bm, (T, 2, 1)), None, F=[[0.0, 1.0]], lo=-0.25, hi=0.25), rho=50.0)
    acc = JAccelerated(qqp, iters=MOM_ITERS)
    g = jnp.asarray(qqp.g_lane_fixed(inp["lti_x0"]))
    res["mom_single"] = np.asarray(jax.jit(acc.solve_words)(acc.init_words(B), g))
    dev = JDeviceSQP(**_sqp_kw(SQP_KW))
    devc = JDeviceConstrainedSQP(JDeviceSQP(**_sqp_kw(CON_SQP_KW)), **CON_KW)
    devq = JDeviceSQP(model=JPlanarQuadrotor(), **_sqp_kw(QUAD_KW))
    sqp_x0, con_x0 = inp["sqp_x0"], inp["con_x0"]

    u32 = {k: inp[k].view(np.uint32) for k in ("pgd_words", "alm_words")}
    pk = dict(iters=PGD_ITERS, g_shift=12)
    ak = dict(outer=ALM_OUTER // 2, inners=ALM_INNERS // 2, g_shift=12, y_shift=_Y_SHIFT)
    alm_rest = [inp["alm_" + k] for k in ("cs_num", "cs_den", "c_off", "lo", "hi", "eh_num",
                                           "eh_den", "el_num", "el_den", "lam")]
    rest_specs = (P("dp"), P("dp"), P("dp", None), P("dp", None), P("dp", None), P("dp"),
                  P("dp"), P("dp"), P("dp"), P("dp", None))
    for dp, tp in MESHES:
        tag = f"dp{dp}tp{tp}"
        mesh = j_make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
        w, _, r = JShardedPGD(qqp, mesh, iters=PGD_ITERS).solve(inp["lti_x0"])
        res[tag + "/pgd_words"], res[tag + "/pgd_res"] = np.asarray(w), float(r)
        w, _, _ = JShardedPGD(qqp, mesh, iters=MOM_ITERS, momentum=True).solve(inp["lti_x0"])
        res[tag + "/mom_words"] = np.asarray(w)
        jscp = JShardedConstrained(qcqp, mesh, outer=ALM_OUTER, inners=ALM_INNERS)
        w, _, lam = jscp.solve(inp["lti_con_x0"])
        res[tag + "/cpgd_words"], res[tag + "/cpgd_lam"] = np.asarray(w), np.asarray(lam)
        jsp = JShardedPGD(qqp, mesh, iters=MOM_ITERS, momentum=True)
        res[tag + "/tp"] = np.array([jsp.tp, jscp.tp])
        res[tag + "/Hq_dev"], res[tag + "/lower_words"] = (np.asarray(jsp.Hq_dev),
                                                           np.asarray(jsp.lower_words))

        block = 16 // tp
        col = dict(axis_name="tp", block=block)
        wt, bf = P("dp", "tp"), P("dp", None, None)
        for name, fn, mat_spec, mat in (
                ("pgd_cols", j_pgd_cols, bf, inp["pgd_hqt"].transpose(0, 2, 1)),
                ("pgd_cols_hqt", j_pgd_cols_hqt, P(None, None, "dp"),
                 inp["pgd_hqt"].transpose(1, 2, 0))):
            sm = jax.shard_map(
                lambda u, g, m, n, d, _fn=fn: _fn(u, g, m, n, d, **pk, **col), mesh=mesh,
                in_specs=(wt, wt, mat_spec, P("dp"), P("dp")), out_specs=wt, check_vma=False)
            res[f"{tag}/{name}"] = np.asarray(jax.jit(sm)(
                u32["pgd_words"], inp["pgd_g"], np.ascontiguousarray(mat),
                inp["pgd_hs_num"], inp["pgd_hs_den"]))
        hqt_bl = np.ascontiguousarray(inp["alm_hqt"].transpose(1, 2, 0))     # (k, j, B)
        for name, fn, mats, mspec in (
                ("alm_cols", j_alm_cols,
                 (inp["alm_hqt"].transpose(0, 2, 1), inp["alm_sqc"]), bf),
                ("alm_cols_hqt", j_alm_cols_hqt,
                 (hqt_bl, np.ascontiguousarray(inp["alm_sqj"].transpose(1, 2, 0))),
                 P(None, None, "dp"))):
            sm = jax.shard_map(
                lambda u, g, h, n, d, s, *rest, _fn=fn: _fn(u, g, h, n, d, s, *rest, **ak, **col),
                mesh=mesh, in_specs=(wt, wt, mspec, P("dp"), P("dp"), mspec) + rest_specs,
                out_specs=(wt, P("dp", None)), check_vma=False)
            w, lam = jax.jit(sm)(u32["alm_words"], inp["alm_g"], np.ascontiguousarray(mats[0]),
                                 inp["alm_hs_num"], inp["alm_hs_den"],
                                 np.ascontiguousarray(mats[1]), *alm_rest)
            res[f"{tag}/{name}"], res[f"{tag}/{name}_lam"] = np.asarray(w), np.asarray(lam)

        row, wts = NamedSharding(mesh, P("dp", None)), NamedSharding(mesh, P("dp", "tp"))
        res[tag + "/dsqp"] = np.asarray(dev.sharded_solve_words(mesh)(
            jax.device_put(dev.init_words(B), wts), jax.device_put(jnp.asarray(sqp_x0), row)))
        w, lam = devc.sharded_solve_words(mesh)(
            jax.device_put(devc.init_words(B), wts), jax.device_put(jnp.asarray(con_x0), row),
            jax.device_put(devc.init_lam(B), row))
        res[tag + "/dcon_words"], res[tag + "/dcon_lam"] = np.asarray(w), np.asarray(lam)
        if (dp, tp) in QUAD_MESHES:
            res[tag + "/qsqp"] = np.asarray(devq.sharded_solve_words(mesh)(
                jax.device_put(devq.init_words(B), wts),
                jax.device_put(jnp.asarray(inp["quad_x0"]), row)))
    return res, dev, devc, devq


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn both worlds, compute JAX's side meanwhile, gather everything."""
    io = tmp_path_factory.mktemp("torch_parallel")
    inp = dict(lti_x0=_x0_lti(B, 0), lti_con_x0=_x0_lti(B, 7) * [0.5, 0.2],
               sqp_x0=_x0_sqp(B, 5), con_x0=_x0_sqp(B, 7, (-np.pi, np.pi)),
               quad_x0=_x0_quad(B, 9), **_operands(),
               ck_words=np.arange(16 * 8, dtype=np.uint32).reshape(16, 8) * np.uint32(2654435761),
               ck_vals=np.arange(8 * 4, dtype=np.int32).reshape(8, 4) - 7)
    np.savez(io / "inputs.npz", **inp)
    # checkpoints written by JAX on its virtual mesh, for the workers to load
    j_save_sharded(str(io / "jax_plan"), JPackedArray.from_words(
        JPackedLayout(8, 8, 8, 8), jax.device_put(jnp.asarray(inp["ck_words"]), NamedSharding(
            j_make_mesh(dp=4, tp=2), P("dp", "tp")))))
    j_save_sharded(str(io / "jax_state"), jax.device_put(jnp.asarray(inp["ck_vals"]), NamedSharding(
        j_make_mesh(dp=2, tp=1, devices=jax.devices()[:2]), P("dp", None))))
    cfg = dict(SQP_KW=SQP_KW, CON_SQP_KW=CON_SQP_KW, CON_KW=CON_KW, PGD_ITERS=PGD_ITERS,
               MOM_ITERS=MOM_ITERS, ALM_OUTER=ALM_OUTER, ALM_INNERS=ALM_INNERS,
               LTI_CON_T=LTI_CON_T, WORLD_MESHES=WORLD_MESHES, B=B, QUAD_KW=QUAD_KW,
               QUAD_MESHES=QUAD_MESHES)
    (io / "config.txt").write_text(repr(cfg))
    (io / "worker.py").write_text(WORKER)
    procs = {w: _spawn(io, w) for w in WORLD_MESHES}
    try:
        jres, jdev, jdevc, jdevq = _jax_side(inp)
    finally:
        outs = {w: _wait(p, w) for w, p in procs.items()}
    for w, texts in outs.items():
        for r, text in enumerate(texts):
            assert f"rank {r} of {w} OK" in text, text[-3000:]
    port = {w: [dict(np.load(io / f"out_w{w}_r{r}.npz")) for r in range(w)] for w in WORLD_MESHES}
    return dict(inp=inp, jax=jres, port=port, jdev=jdev, jdevc=jdevc, jdevq=jdevq, io=io)


def _rank0(run, dp, tp):
    return run["port"][dp * tp][0]


def _u32(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_pgd_bit_identical_to_jax(run, dp, tp):
    tag, p, j = f"dp{dp}tp{tp}", _rank0(run, dp, tp), run["jax"]
    np.testing.assert_array_equal(_u32(p[tag + "/pgd_words"]), j[tag + "/pgd_words"])
    np.testing.assert_allclose(float(p[tag + "/pgd_res"]), j[tag + "/pgd_res"], rtol=1e-6)
    from pint_tpu_torch.convert import quantized_qp_from_arrays
    from pint_tpu_torch.mpc import FixedPointPGD

    single = FixedPointPGD(quantized_qp_from_arrays(j_quantize(j_condense(T=50))),
                           iters=PGD_ITERS, device="cpu")
    np.testing.assert_array_equal(p[tag + "/pgd_words"], single.solve(run["inp"]["lti_x0"])[0])


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_pgd_momentum_bit_identical_to_accelerated(run, dp, tp):
    from pint_tpu_torch.mpc import AcceleratedPGD, condense_double_integrator, quantize

    tag, p, j = f"dp{dp}tp{tp}", _rank0(run, dp, tp), run["jax"]
    acc = AcceleratedPGD(quantize(condense_double_integrator(T=50)), iters=MOM_ITERS, device="cpu")
    words = acc.solve(run["inp"]["lti_x0"])[0].numpy()
    np.testing.assert_array_equal(_u32(words), j["mom_single"])
    np.testing.assert_array_equal(p[tag + "/mom_words"], words)
    np.testing.assert_array_equal(_u32(p[tag + "/mom_words"]), j[tag + "/mom_words"])


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_constrained_pgd_bit_identical_to_jax(run, dp, tp):
    tag, j = f"dp{dp}tp{tp}", run["jax"]
    for rank_out in run["port"][dp * tp]:
        np.testing.assert_array_equal(_u32(rank_out[tag + "/cpgd_words"]), j[tag + "/cpgd_words"])
        np.testing.assert_array_equal(rank_out[tag + "/cpgd_lam"], j[tag + "/cpgd_lam"])
    assert np.abs(j[tag + "/cpgd_lam"]).max() > 0


@pytest.mark.parametrize("name", ["pgd_cols", "pgd_cols_hqt"])
@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_pgd_column_inners_bit_identical(run, dp, tp, name):
    """Given identical quantized operands: the column inner equals the
    port's single-device _pgd_batched_h and JAX's column function under
    shard_map (the hqt form through K10's plain version)."""
    tag, p, inp = f"dp{dp}tp{tp}", _rank0(run, dp, tp), run["inp"]
    Hq = torch.from_numpy(inp["pgd_hqt"]).permute(0, 2, 1)
    single = _pgd_batched_h(torch.from_numpy(inp["pgd_words"]), torch.from_numpy(inp["pgd_g"]),
                            Hq, torch.from_numpy(inp["pgd_hs_num"]),
                            torch.from_numpy(inp["pgd_hs_den"]), iters=PGD_ITERS, g_shift=12)
    np.testing.assert_array_equal(p[f"{tag}/{name}"], single.numpy())
    np.testing.assert_array_equal(_u32(p[f"{tag}/{name}"]), run["jax"][f"{tag}/{name}"])


@pytest.mark.parametrize("name", ["alm_cols", "alm_cols_hqt"])
@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_alm_column_inners_bit_identical(run, dp, tp, name):
    tag, inp, j = f"dp{dp}tp{tp}", run["inp"], run["jax"]
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    w, lam = _alm_batched(
        t["alm_words"], t["alm_g"], t["alm_hqt"].permute(0, 2, 1), t["alm_hs_num"],
        t["alm_hs_den"], t["alm_sqc"], *[t["alm_" + k] for k in (
            "cs_num", "cs_den", "c_off", "lo", "hi", "eh_num", "eh_den", "el_num",
            "el_den", "lam")],
        outer=ALM_OUTER // 2, inners=ALM_INNERS // 2, g_shift=12, y_shift=_Y_SHIFT)
    outs = run["port"][dp * tp]
    np.testing.assert_array_equal(outs[0][f"{tag}/{name}"], w.numpy())
    np.testing.assert_array_equal(_u32(outs[0][f"{tag}/{name}"]), j[f"{tag}/{name}"])
    np.testing.assert_array_equal(j[f"{tag}/{name}_lam"], lam.numpy())
    assert np.abs(lam.numpy()).max() > 0
    rows = B // dp
    for r, o in enumerate(outs):       # lam is the same on every tp rank
        r_dp = int(o[f"{tag}/r{r}/coords"][0])
        np.testing.assert_array_equal(o[f"{tag}/r{r}/{name}_lam"],
                                      lam.numpy()[r_dp * rows:(r_dp + 1) * rows])


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_device_sqp_sharded_bit_identical_and_cost_parity(run, dp, tp):
    """D4: the sharded solve equals the port's single-device solve_words;
    against JAX's sharded solve, cost parity."""
    tag, p, j = f"dp{dp}tp{tp}", _rank0(run, dp, tp), run["jax"]
    np.testing.assert_array_equal(p[tag + "/dsqp"], p["ref/dsqp"])
    host = QuantizedSQP(**_sqp_kw(SQP_KW))
    x0 = run["inp"]["sqp_x0"].astype(np.float64)
    cost = host.true_cost(x0, host.lanes(jnp.asarray(_u32(p[tag + "/dsqp"]))))
    cost_ref = host.true_cost(x0, host.lanes(jnp.asarray(j[tag + "/dsqp"])))
    np.testing.assert_allclose(cost, cost_ref, rtol=0.01, atol=1e-4)
    cold = host.true_cost(x0, np.zeros((B, 16)))
    assert cost.mean() < cold.mean()


@pytest.mark.parametrize("dp,tp", QUAD_MESHES, ids=[f"dp{d}tp{t}" for d, t in QUAD_MESHES])
def test_quadrotor_sharded_bit_identical_and_cost_parity(run, dp, tp):
    """The planar quadrotor's DeviceSQP.sharded_solve_words (n 6, m 2, Tm
    32 over 8 words a problem): D4, the sharded words equal the port's own
    solve_words; against JAX's sharded solve on the same mesh, cost parity;
    better than the zero (pure-hover) plan."""
    tag, p, j = f"dp{dp}tp{tp}", _rank0(run, dp, tp), run["jax"]
    np.testing.assert_array_equal(p[tag + "/qsqp"], p["ref/qsqp"])
    port = device_sqp_config(run["jdevq"], device="cpu")
    x0 = run["inp"]["quad_x0"]
    lp = unpack_controls(torch.from_numpy(p[tag + "/qsqp"]))[:, :32].numpy()
    lj = unpack_controls(torch.from_numpy(j[tag + "/qsqp"].view(np.int32).copy()))[:, :32].numpy()
    cost = port.true_cost(x0, lp)
    np.testing.assert_allclose(cost, port.true_cost(x0, lj), rtol=0.01, atol=1e-4)
    assert cost.mean() < port.true_cost(x0, np.zeros((B, 32))).mean()


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_device_constrained_sharded_bit_identical_and_parity(run, dp, tp):
    tag, j = f"dp{dp}tp{tp}", run["jax"]
    outs = run["port"][dp * tp]
    ref_w, ref_l = outs[0]["ref/dcon_words"], outs[0]["ref/dcon_lam"]
    rows = B // dp
    for name in ("dcon", "dcon_word"):
        np.testing.assert_array_equal(outs[0][f"{tag}/{name}_words"], ref_w)
        for r, o in enumerate(outs):       # lam needs no collective to stay replicated
            r_dp = int(o[f"{tag}/r{r}/coords"][0])
            np.testing.assert_array_equal(o[f"{tag}/r{r}/{name}_lam"],
                                          ref_l[r_dp * rows:(r_dp + 1) * rows])
    assert np.abs(ref_l).max() > 0
    port = device_constrained_config(run["jdevc"], device="cpu")
    x0 = run["inp"]["con_x0"]
    lp = unpack_controls(torch.from_numpy(ref_w))[:, :16].numpy()
    lj = unpack_controls(torch.from_numpy(j[tag + "/dcon_words"].view(np.int32)))[:, :16].numpy()
    cost, cost_j = port.dev.true_cost(x0, lp), port.dev.true_cost(x0, lj)
    np.testing.assert_allclose(cost, cost_j, rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(port.violation(x0, lp), port.violation(x0, lj), atol=5e-3)


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_fused_dp_sharded_equals_solve_words(run, dp, tp):
    from pint_tpu_torch.mpc import FusedPGD, condense_double_integrator, quantize

    qqp = quantize(condense_double_integrator(T=50))
    fp = FusedPGD(qqp, iters=PGD_ITERS, device="cpu")
    g = torch.as_tensor(qqp.g_lane_fixed(run["inp"]["lti_x0"]))
    np.testing.assert_array_equal(_rank0(run, dp, tp)[f"dp{dp}tp{tp}/fused_dp"],
                                  fp.solve_words(fp.init_words(B), g).numpy())


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_mesh_coordinates_are_dp_major(run, dp, tp):
    for r, o in enumerate(run["port"][dp * tp]):
        assert tuple(o[f"dp{dp}tp{tp}/r{r}/coords"]) == (r // tp, r % tp)


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_solve_rejects_bad_tp(run, dp, tp):
    """A horizon whose lanes do not split into 4-lane words across tp
    raises ValueError (n_dec = 36; 4*tp = 8 or 16); tp = 1 always splits."""
    msgs = _rank0(run, dp, tp)[f"dp{dp}tp{tp}/bad_tp"]
    for m in msgs:
        assert ("divide into 4-lane" in m) == (tp > 1), m


@pytest.mark.parametrize("world", sorted(WORLD_MESHES))
def test_aggregate_rate_sums_over_ranks(run, world):
    for r, o in enumerate(run["port"][world]):
        assert float(o["rate"]) == pytest.approx(sum(1.5 * (k + 1) for k in range(world)))
        assert bool(o["multi"]) and tuple(o["info"]) == (r, world)


@pytest.mark.parametrize("world", sorted(WORLD_MESHES))
def test_host_local_mesh_spans_this_hosts_ranks(run, world):
    """LOCAL_WORLD_SIZE = 2: each host's two ranks form a tp = 2 mesh whose
    group sums over that host only."""
    for r, o in enumerate(run["port"][world]):
        host = r // 2
        ranks = [2 * host, 2 * host + 1]
        assert o["host_mesh"].tolist() == ranks + [sum(k + 1 for k in ranks), 0, r % 2]


@pytest.mark.parametrize("world", sorted(WORLD_MESHES))
def test_make_mesh_raises_on_wrong_world_size(run, world):
    assert "needs" in str(run["port"][world][0]["wrong_world"])


# -- in this process, no world -----------------------------------------------


_ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
        "MASTER_PORT", "RANK", "WORLD_SIZE")


def test_initialize_is_a_noop_without_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    D.initialize()
    assert not torch.distributed.is_initialized()
    assert not D.is_multi_process() and D.aggregate_rate(3.5) == 3.5
    assert D.process_info()["process_count"] == 1


def test_initialize_raises_when_half_configured(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="process count"):
        D.initialize("127.0.0.1:1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="coordinator"):
        D.initialize()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(dp=1, tp=1, device="cpu")


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("rows", [64, 128])
def test_matvec_cols_plain_matches_jax_kernel(K, rows):
    """K10's plain version against JAX's Pallas kernel (interpret mode) at
    a batch that is no multiple of any block, on full-range int8 lanes."""
    rng = np.random.default_rng(K * rows)
    Bn = 37
    lanes = rng.integers(-128, 128, (Bn, K), dtype=np.int32)
    hqt = rng.integers(-128, 128, (K, rows, Bn), dtype=np.int8)
    expect = np.asarray(j_matvec(jnp.asarray(lanes), jnp.asarray(hqt), block=8,
                                 interpret=True))
    got = pgd_matvec_cols(torch.from_numpy(lanes), torch.from_numpy(hqt))
    assert got.dtype == torch.int32 and got.shape == (Bn, rows)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(pgd_matvec_cols_plain(torch.from_numpy(lanes),
                                                        torch.from_numpy(hqt)).numpy(), expect)


def test_matvec_cols_rejects_bad_operands():
    with pytest.raises(ValueError, match="do not agree"):
        pgd_matvec_cols(torch.zeros((4, 8), dtype=torch.int32),
                        torch.zeros((8, 16, 5), dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        pgd_matvec_cols(torch.zeros((4, 8), dtype=torch.int32),
                        torch.zeros((8, 16, 4), dtype=torch.int32))


def _coords(run, dp, tp):
    """Each rank's (r_dp, r_tp) on the mesh, with its results."""
    return [(tuple(int(c) for c in o[f"dp{dp}tp{tp}/r{r}/coords"]), o)
            for r, o in enumerate(run["port"][dp * tp])]


def _block(a, dp, tp, c, spec=("dp", "tp")):
    rows, cols = a.shape[0] // dp, a.shape[1] // (tp if spec[1] == "tp" else 1)
    r = slice(c[0] * rows, (c[0] + 1) * rows) if spec[0] == "dp" else slice(None)
    k = slice(c[1] * cols, (c[1] + 1) * cols) if spec[1] == "tp" else slice(None)
    return a[r, k]


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_device_sqp_fused_false_sharded_bit_identical(run, dp, tp):
    """``DeviceSQP(fused=False)``'s sharded solve (the word-space inner at
    tp == 1, the plain column dot at tp > 1, no K10) equals the default
    solver's one-device solve_words."""
    tag, p = f"dp{dp}tp{tp}", _rank0(run, dp, tp)
    np.testing.assert_array_equal(p[tag + "/dsqp_fused_false"], p["ref/dsqp"])


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_solver_members_match_jax(run, dp, tp):
    """ShardedPGD's ``tp``, ``Hq_dev`` and ``lower_words`` and
    ShardedConstrainedPGD's ``tp`` hold JAX's values on every rank."""
    tag, j = f"dp{dp}tp{tp}", run["jax"]
    for r, o in enumerate(run["port"][dp * tp]):
        np.testing.assert_array_equal(o[f"{tag}/r{r}/tp"], j[tag + "/tp"])
        assert o[f"{tag}/r{r}/Hq_dev"].dtype == np.int8
        np.testing.assert_array_equal(o[f"{tag}/r{r}/Hq_dev"], j[tag + "/Hq_dev"])
        np.testing.assert_array_equal(_u32(o[f"{tag}/r{r}/lower_words"]), j[tag + "/lower_words"])


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_checkpoint_roundtrip(run, dp, tp):
    """tests/test_utils.py:47-69 on a real mesh: each rank writes its own
    file, loads its own block back bit-exactly with the widths, and
    ``load_full`` joins every rank's file."""
    tag, words = f"dp{dp}tp{tp}", run["inp"]["ck_words"]
    for c, o in _coords(run, dp, tp):
        mine = f"{tag}/r{c[0] * tp + c[1]}"
        assert str(o[mine + "/ck_path"]) == f"ck_{tag}_plan.proc{c[0] * tp + c[1]}.npz"
        assert tuple(o[mine + "/ck_widths"]) == (8, 8, 8, 8)
        np.testing.assert_array_equal(_u32(o[mine + "/ck_plan"]), _block(words, dp, tp, c))
        np.testing.assert_array_equal(o[mine + "/ck_full"], words)


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_checkpoint_reshards(run, dp, tp):
    """tests/test_utils.py:72-79: rows saved by dp (tp-replicated) restore
    as (dp, tp) blocks and as the whole array; the first mesh's files of a
    world restore on its second mesh."""
    tag, vals = f"dp{dp}tp{tp}", run["inp"]["ck_vals"]
    words = run["inp"]["ck_words"]
    first = [m for m in WORLD_MESHES[dp * tp]][0]
    for c, o in _coords(run, dp, tp):
        mine = f"{tag}/r{c[0] * tp + c[1]}"
        assert o[mine + "/ck_reshard"].dtype == np.int32
        np.testing.assert_array_equal(o[mine + "/ck_reshard"], _block(vals, dp, tp, c))
        np.testing.assert_array_equal(o[mine + "/ck_whole"], vals)
        if (dp, tp) != first:
            np.testing.assert_array_equal(_u32(o[mine + "/ck_cross"]), _block(words, dp, tp, c))


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_sharded_checkpoint_missing_shard_raises(run, dp, tp):
    """tests/test_utils.py:84-105: with the last rank's file gone, that
    rank's block and the whole array raise "cover only"; every other
    rank's block still loads."""
    tag, n = f"dp{dp}tp{tp}", dp * tp
    for c, o in _coords(run, dp, tp):
        r = c[0] * tp + c[1]
        block_msg, full_msg = (str(m) for m in o[f"{tag}/r{r}/ck_missing"])
        assert ("cover only" in block_msg) == (r == n - 1), block_msg
        assert "cover only" in full_msg


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_jax_written_checkpoints_load_on_port_meshes(run, dp, tp):
    """Files JAX's save_sharded wrote on its virtual mesh (8 shards of a
    packed plan; 2 row shards of int32 values) load as each rank's block."""
    tag, inp = f"dp{dp}tp{tp}", run["inp"]
    for c, o in _coords(run, dp, tp):
        mine = f"{tag}/r{c[0] * tp + c[1]}"
        assert tuple(o[mine + "/ck_jax_widths"]) == (8, 8, 8, 8)
        np.testing.assert_array_equal(_u32(o[mine + "/ck_jax_plan"]),
                                      _block(inp["ck_words"], dp, tp, c))
        np.testing.assert_array_equal(o[mine + "/ck_jax_state"], _block(inp["ck_vals"], dp, tp, c))


@pytest.mark.parametrize("dp,tp", MESHES, ids=IDS)
def test_port_written_checkpoints_load_in_jax(run, dp, tp):
    """The ranks' files read by JAX's load_full and load_sharded (onto its
    own 4 x 2 mesh): unsigned words, the widths, every value."""
    prefix, inp = str(run["io"] / f"ck_dp{dp}tp{tp}"), run["inp"]
    full, widths = j_load_full(prefix + "_plan")
    assert widths == (8, 8, 8, 8) and full.dtype == np.uint32
    np.testing.assert_array_equal(full, inp["ck_words"])
    sharding = NamedSharding(j_make_mesh(dp=4, tp=2), P("dp", "tp"))
    for name, want in (("_plan", inp["ck_words"]), ("_state", inp["ck_vals"])):
        back, _ = j_load_sharded(prefix + name, sharding)
        assert back.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(back), want)
