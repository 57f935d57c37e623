"""Port parity: the trajectory costs (``pint_tpu_torch.mpc.costs``), the
sampling planner (``mpc/mppi.py``) and the gradient planner
(``mpc/nonlinear.py``) against ``pint_tpu``'s, on the CPU.

Tolerances, by grade:
- each cost function on the same trajectories: rtol 1e-6 (float32 sums in
  another order);
- MPPI on JAX's own noise (a torch generator never draws JAX's numbers, so
  the noise is handed in through ``_sample_noise``): candidates and rollouts
  bit-identical, costs rtol 1e-6, the new lanes equal apart from rounding
  ties of the weighted mean (a differing lane must be within 1e-3 of a .5
  tie; on these seeds none differs); the median averages the two middle
  costs for an even K, as ``jnp.median`` does; whole plans and closed loops
  at cost parity (rtol 0.01, atol 1e-4);
- the nonlinear planner: ``torch.autograd`` gradients rtol 1e-5 against
  ``jax.grad``; whole solves and closed loops at cost parity, with the
  count of lanes that differ printed, and reaching the goal as
  ``tests/test_nonlinear.py`` asserts.
"""

import ast
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pint_tpu.mpc as JM
from pint_tpu.models import Unicycle as JUnicycle
from pint_tpu.mpc import costs as JC
from pint_tpu.mpc.mppi import QuantizedMPPI as JMPPI
from pint_tpu.mpc.mppi import unicycle_goal_cost as j_goal
from pint_tpu.mpc.nonlinear import QuantizedNonlinearPGD as JNL
from pint_tpu.models.dynamics import CONTROL_LAYOUT as J_LAYOUT
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.models.dynamics import unpack_controls as j_unpack
from pint_tpu.ops import word as JW
import pint_tpu_torch.mpc as M
from pint_tpu_torch.convert import mppi_config, nonlinear_config, words_from_numpy, words_to_numpy
from pint_tpu_torch.models import Unicycle
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.mpc import QuantizedMPPI, QuantizedNonlinearPGD, costs as C
from pint_tpu_torch.mpc import unicycle_goal_cost
from pint_tpu_torch.mpc.mppi import _median

REPO = pathlib.Path(__file__).resolve().parents[1]
JMODEL, MODEL = JUnicycle(v_shift=10, w_shift=8), Unicycle(v_shift=10, w_shift=8)


def test_port_exports_every_mpc_name():
    """``pint_tpu_torch.mpc.__all__`` holds every name of
    ``pint_tpu.mpc.__all__``, and the costs module exists."""
    assert set(JM.__all__) <= set(M.__all__)
    assert all(hasattr(M, n) for n in M.__all__)
    assert (REPO / "pint_tpu_torch" / "mpc" / "costs.py").is_file()
    names = ast.literal_eval(re.search(r"__all__ = (\[.*?\])",
                                       (REPO / "pint_tpu/mpc/costs.py").read_text(),
                                       re.S).group(1))
    assert set(names) == set(C.__all__)


# -- costs ---------------------------------------------------------------------


def _trajectories(seed, B=6, T=24):
    rng = np.random.default_rng(seed)
    st = np.concatenate([rng.integers(-2**17, 2**17, (B, T + 1, 2)),
                         rng.integers(-2**16, 2**16, (B, T + 1, 1))], -1).astype(np.int32)
    ctrl = rng.integers(-128, 128, (B, T, 2)).astype(np.int32)
    return st, ctrl


def _cost_pairs(goal):
    obst = [(0.8, 0.06), (-0.5, 1.0)]
    return {
        "goal": (JC.goal_cost(JMODEL, goal), C.goal_cost(MODEL, goal)),
        "goal_w3": (JC.goal_cost(JMODEL, goal, 3.0), C.goal_cost(MODEL, goal, 3.0)),
        "obstacle": (JC.obstacle_cost(JMODEL, obst, radius=0.7),
                     C.obstacle_cost(MODEL, obst, radius=0.7)),
        "effort": (JC.control_effort_cost(), C.control_effort_cost()),
        "rate": (JC.control_rate_cost(1e-4), C.control_rate_cost(1e-4)),
        "combine": (JC.combine(JC.goal_cost(JMODEL, goal),
                               JC.obstacle_cost(JMODEL, obst, radius=0.7),
                               JC.control_effort_cost(), JC.control_rate_cost()),
                    C.combine(C.goal_cost(MODEL, goal),
                              C.obstacle_cost(MODEL, obst, radius=0.7),
                              C.control_effort_cost(), C.control_rate_cost())),
        "unicycle_goal": (j_goal(JMODEL, jnp.asarray(goal)), unicycle_goal_cost(MODEL, goal)),
    }


KINDS = ["goal", "goal_w3", "obstacle", "effort", "rate", "combine"]


@pytest.mark.parametrize("kind,fixed", [(k, f) for k in KINDS for f in (True, False)]
                         + [("unicycle_goal", True)])
def test_cost_functions_match(kind, fixed):
    """On fixed-point trajectories and on float32 physical ones
    (``unicycle_goal_cost`` takes fixed-point states only)."""
    st, ctrl = _trajectories(0)
    goal = np.random.default_rng(1).uniform(-1, 1, (6, 2)).astype(np.float32)
    if not fixed:
        st = (st * 2.0**-16).astype(np.float32)
    jfn, pfn = _cost_pairs(goal)[kind]
    want = np.asarray(jax.jit(jfn)(jnp.asarray(st), jnp.asarray(ctrl)))
    got = pfn(torch.as_tensor(st), torch.as_tensor(ctrl)).numpy()
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_obstacle_cost_penalizes_inside():
    c = C.obstacle_cost(Unicycle(), [(1.0, 0.0)], radius=0.5, weight=100.0)
    m = Unicycle()
    inside = np.concatenate([m.to_fixed_xy(np.array([[1.0, 0.0]])), [[0]]], -1)[None]
    outside = np.concatenate([m.to_fixed_xy(np.array([[3.0, 3.0]])), [[0]]], -1)[None]
    ctrl = torch.zeros((1, 1, 2), dtype=torch.int32)
    assert float(c(torch.as_tensor(inside.astype(np.int32)), ctrl)[0]) > 50
    assert float(c(torch.as_tensor(outside.astype(np.int32)), ctrl)[0]) == 0.0


# -- MPPI --------------------------------------------------------------------------


class _Injected(QuantizedMPPI):
    """The port's MPPI drawing its noise from a queue (JAX's noise)."""

    def _sample_noise(self, gen, batch):
        return torch.as_tensor(self.queue.pop(0), device=self.device)


def _injected(ref, noises):
    p = mppi_config(ref, device="cpu")
    p = _Injected(**{k: getattr(p, k) for k in
                     ("model", "horizon", "samples", "noise_lanes", "temperature", "device")})
    object.__setattr__(p, "queue", [np.array(n) for n in noises])
    return p


@pytest.fixture(scope="module")
def mppi_ref():
    return JMPPI(JMODEL, horizon=40, samples=256, noise_lanes=30)


GOALS = np.array([[1.5, 0.8], [-1.0, 1.2], [0.3, -0.4]], np.float32)


def test_median_even_and_odd_k():
    """jnp.median averages the two middles for an even count; torch.median
    would take the lower (checked to differ on this input)."""
    rng = np.random.default_rng(2)
    for k in (256, 255, 512, 2):
        x = rng.standard_normal((5, k)).astype(np.float32) * 100.0
        np.testing.assert_array_equal(_median(torch.as_tensor(x)).numpy(),
                                      np.asarray(jnp.median(x, axis=-1, keepdims=True)))
    x = torch.as_tensor(rng.standard_normal((3, 256)).astype(np.float32))
    assert not torch.equal(_median(x)[:, 0], torch.median(x, dim=-1).values)


def test_mppi_step_on_jax_noise(mppi_ref):
    """One update from seeded warm words on JAX's noise: candidates and
    rollouts bit-identical, costs rtol 1e-6, best costs rtol 1e-6, new
    lanes equal but for .5 ties of the weighted mean."""
    ref = mppi_ref
    B = 3
    key = jax.random.PRNGKey(3)
    noise = np.asarray(ref._sample_noise(key, B))
    lanes0 = np.random.default_rng(4).integers(-60, 61, (B, 80)).astype(np.int32)
    w0 = np.asarray(j_pack(jnp.asarray(lanes0)))
    s0 = np.random.default_rng(5).integers(-2**15, 2**15, (B, 3)).astype(np.int32)
    jcost = j_goal(JMODEL, jnp.asarray(GOALS)[:, None, :])
    pcost = unicycle_goal_cost(MODEL, GOALS[:, None, :])
    port = _injected(ref, [noise])

    # the reference's step, line by line, for its intermediates
    cand = JW.add_signed_saturate(J_LAYOUT, jnp.asarray(w0)[:, None, :],
                                  j_pack(jnp.asarray(noise)))
    jl = j_unpack(cand)
    jctrl = jl.reshape(B, 256, 40, 2)
    jst = JMODEL.rollout(jnp.broadcast_to(jnp.asarray(s0)[:, None, :], (B, 256, 3)), jctrl)
    jc = np.asarray(jcost(jst, jctrl))
    pl, pctrl, pst = port._rollouts(words_from_numpy(w0, device="cpu"),
                                    torch.as_tensor(noise.copy()), torch.as_tensor(s0))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(pcost(pst, pctrl).numpy(), jc, rtol=1e-6)

    jw, jbest = jax.jit(lambda k, w, s: ref.step(k, w, s, jcost))(key, jnp.asarray(w0),
                                                                    jnp.asarray(s0))
    pw, pbest = port.step(None, words_from_numpy(w0, device="cpu"), torch.as_tensor(s0),
                          pcost)
    np.testing.assert_allclose(pbest.numpy(), np.asarray(jbest), rtol=1e-6)
    got = unpack_controls(pw).numpy()
    want = np.asarray(j_unpack(jw))
    # the reference's weighted mean, for the ties
    mu = jc.min(-1, keepdims=True)
    scale = (np.asarray(jnp.median(jnp.asarray(jc), axis=-1, keepdims=True)) - mu) + 1e-6
    w = np.asarray(jax.nn.softmax(-(jc - mu) / (scale * ref.temperature), axis=-1))
    mean = np.einsum("bk,bkl->bl", w.astype(np.float64), np.asarray(jl, np.float64))
    diff = got != want
    assert np.all(np.abs(np.abs(mean[diff] - np.floor(mean[diff])) - 0.5) < 1e-3)
    assert diff.sum() == 0, f"{diff.sum()} lanes differ (ties)"


def _plan_noise(ref, key, B, updates):
    return [np.asarray(ref._sample_noise(k, B)) for k in jax.random.split(key, updates)]


def test_mppi_plan_on_jax_noise(mppi_ref):
    """tests/test_mppi.py's goals, 10 updates on JAX's noise: the final
    plans at cost parity (their rollouts scored by the same cost), both
    within 0.5 of the goals, lanes in the box."""
    ref = mppi_ref
    B = 2
    key = jax.random.PRNGKey(0)
    goal = GOALS[:B]
    jw, jbest = jax.jit(lambda k, s: ref.plan(k, s, j_goal(JMODEL, jnp.asarray(goal)[:, None, :]),
                                              updates=10))(key, jnp.zeros((B, 3), jnp.int32))
    port = _injected(ref, _plan_noise(ref, key, B, 10))
    pcost = unicycle_goal_cost(MODEL, goal[:, None, :])
    pw, pbest = port.plan(None, torch.zeros((B, 3), dtype=torch.int32), pcost, updates=10)
    assert not port.queue
    s0 = torch.zeros((B, 3), dtype=torch.int32)
    trajs = []
    for words in (pw, words_from_numpy(np.asarray(jw), device="cpu")):
        ctrl = unpack_controls(words).reshape(B, 40, 2)
        states = MODEL.rollout(s0, ctrl)
        trajs.append((pcost(states, ctrl).numpy(), states.numpy()))
    n_diff = int((words_to_numpy(pw) != np.asarray(jw)).sum())
    print(f"MPPI plan: {n_diff} words differ from JAX's")
    np.testing.assert_allclose(trajs[0][0], trajs[1][0], rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(pbest.numpy(), np.asarray(jbest), rtol=0.01, atol=1e-4)
    for _, st in trajs:
        assert (np.linalg.norm(st[:, -1, :2] * 2.0**-16 - goal, axis=-1) < 0.5).all()


def test_mppi_closed_loop_on_jax_noise(mppi_ref):
    """A 20-tick closed loop, 2 updates a tick, on JAX's noise: the
    trajectories' costs at parity and the applied lanes in the box."""
    ref = mppi_ref
    key = jax.random.PRNGKey(5)
    goal = GOALS[:1]
    ticks = 20
    noises = []
    for k in jax.random.split(key, ticks):
        noises += [np.asarray(ref._sample_noise(kk, 1)) for kk in jax.random.split(k, 2)]
    js, jc = jax.jit(lambda k, s: ref.run_closed_loop(
        k, s, j_goal(JMODEL, jnp.asarray(goal)[:, None, :]), ticks=ticks))(
        key, jnp.zeros((1, 3), jnp.int32))
    port = _injected(ref, noises)
    pcost = unicycle_goal_cost(MODEL, goal[:, None, :])
    ps, pc = port.run_closed_loop(None, torch.zeros((1, 3), dtype=torch.int32), pcost, ticks)
    assert ps.shape == (1, ticks + 1, 3) and pc.shape == (1, ticks, 2) and not port.queue
    n_diff = int((ps.numpy() != np.asarray(js)).sum())
    print(f"MPPI closed loop: {n_diff} state values differ from JAX's")
    np.testing.assert_allclose(pcost(ps, pc).numpy(),
                               pcost(torch.as_tensor(np.array(js)),
                                     torch.as_tensor(np.array(jc))).numpy(),
                               rtol=0.01, atol=1e-4)
    assert np.abs(pc.numpy()).max() <= 127


def test_mppi_with_a_torch_generator(mppi_ref):
    """The port's own noise (a seeded torch.Generator): deterministic for a
    seed, and the plan reaches tests/test_mppi.py's goals (within 0.5)."""
    port = mppi_config(mppi_ref, device="cpu")
    goal = GOALS[:2]
    cost = unicycle_goal_cost(MODEL, goal[:, None, :])
    s0 = torch.zeros((2, 3), dtype=torch.int32)
    w1, b1 = port.plan(torch.Generator().manual_seed(0), s0, cost, updates=10)
    w2, b2 = port.plan(torch.Generator().manual_seed(0), s0, cost, updates=10)
    assert torch.equal(w1, w2) and torch.equal(b1, b2)
    states = MODEL.rollout(s0, unpack_controls(w1).reshape(2, 40, 2)).numpy()
    assert (np.linalg.norm(states[:, -1, :2] * 2.0**-16 - goal, axis=-1) < 0.5).all()
    noise = port._sample_noise(torch.Generator().manual_seed(1), 2)
    assert noise.shape == (2, 256, 80) and noise.dtype == torch.int32
    assert noise.abs().max() <= 127


# -- the nonlinear planner -------------------------------------------------------


def _nl_costs(goal):
    obst = [(0.8, 0.06)]
    return (JC.combine(JC.goal_cost(JMODEL, goal), JC.obstacle_cost(JMODEL, obst, radius=0.3),
                       JC.control_effort_cost()),
            C.combine(C.goal_cost(MODEL, goal), C.obstacle_cost(MODEL, obst, radius=0.3),
                      C.control_effort_cost()))


@pytest.mark.parametrize("seed", [0, 1])
def test_nonlinear_gradient_matches_jax_grad(seed):
    """The autograd gradient of the planner's objective through the f32
    twin against jax.grad of the reference's: rtol 1e-5."""
    rng = np.random.default_rng(seed)
    B, T = 4, 48
    u = (rng.uniform(-1, 1, (B, T, 2)) * 127 * np.array([MODEL.v_scale, MODEL.w_scale])
         ).astype(np.float32)
    x0 = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    goal = rng.uniform(-1.5, 1.5, (B, 2)).astype(np.float32)
    jcost, pcost = _nl_costs(goal)
    want = np.asarray(jax.grad(lambda uu: jnp.sum(jcost(JMODEL.rollout_f32(
        jnp.asarray(x0), uu), uu)))(jnp.asarray(u)))
    got = QuantizedNonlinearPGD(MODEL, horizon=T, device="cpu").grad(
        torch.as_tensor(u), torch.as_tensor(x0), pcost).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _traj_cost(cost, states, words, T):
    ctrl = unpack_controls(words).reshape(-1, T, 2)
    return cost(torch.as_tensor(np.array(states)), ctrl).numpy()


@pytest.mark.parametrize("case", ["goal", "obstacle"])
def test_nonlinear_solve_cost_parity(case):
    """tests/test_nonlinear.py's goal solve (T 48, 60 iterations) and its
    obstacle solve (80 iterations): the quantized trajectories at cost
    parity, the differing lanes counted, and the reference test's goal and
    clearance bounds met."""
    if case == "goal":
        goal = np.array([[1.5, 0.7], [-1.2, 0.9]], np.float32)
        jcost, pcost = JC.goal_cost(JMODEL, goal), C.goal_cost(MODEL, goal)
        iters = 60
    else:
        goal = np.array([[1.6, 0.0]], np.float32)
        jcost, pcost = _nl_costs(goal)
        iters = 80
    B = goal.shape[0]
    ref = JNL(JMODEL, horizon=48, iters=iters)
    port = nonlinear_config(ref, device="cpu")
    s0 = np.zeros((B, 3), np.int32)
    jw, js = jax.jit(lambda s: ref.solve(s, jcost))(jnp.asarray(s0))
    pw, ps = port.solve(torch.as_tensor(s0), pcost)
    n_diff = int((unpack_controls(pw).numpy() != np.asarray(j_unpack(jw))).sum())
    print(f"nonlinear {case}: {n_diff} of {pw.numel() * 4} lanes differ from JAX's")
    np.testing.assert_allclose(_traj_cost(pcost, ps.numpy(), pw, 48),
                               _traj_cost(pcost, np.asarray(js), words_from_numpy(
                                   np.asarray(jw), device="cpu"), 48), rtol=0.01, atol=1e-4)
    xy = ps.numpy()[:, :, :2] * 2.0**-16
    if case == "goal":
        assert np.linalg.norm(xy[:, -1] - goal, axis=-1).max() < 0.25
    else:
        assert np.linalg.norm(xy[0] - np.array([0.8, 0.06]), axis=-1).min() > 0.15
        assert np.linalg.norm(xy[0, -1] - goal[0]) < 0.45


def test_nonlinear_closed_loop_cost_parity():
    """tests/test_nonlinear.py's closed loop (T 32, 8 iterations, steps 8 ->
    1, 50 ticks of 6): cost parity, within 0.35 of the goal, deterministic."""
    goal = np.array([[1.0, 0.5]], np.float32)
    ref = JNL(JMODEL, horizon=32, iters=8, step_lanes=8.0, final_lanes=1.0)
    port = nonlinear_config(ref, device="cpu")
    s0 = np.zeros((1, 3), np.int32)
    js, jc = jax.jit(lambda s: ref.run_closed_loop(s, JC.goal_cost(JMODEL, goal), ticks=50,
                                                   iters_per_tick=6))(jnp.asarray(s0))
    pcost = C.goal_cost(MODEL, goal)
    ps, pc = port.run_closed_loop(torch.as_tensor(s0), pcost, 50, 6)
    assert ps.shape == (1, 51, 3) and pc.shape == (1, 50, 2)
    print(f"nonlinear closed loop: {int((ps.numpy() != np.asarray(js)).sum())} state "
          "values differ from JAX's")
    np.testing.assert_allclose(pcost(ps, pc).numpy(),
                               pcost(torch.as_tensor(np.array(js)),
                                     torch.as_tensor(np.array(jc))).numpy(),
                               rtol=0.01, atol=1e-4)
    assert np.linalg.norm(ps.numpy()[0, -1, :2] * 2.0**-16 - goal[0]) < 0.35
    ps2, _ = port.run_closed_loop(torch.as_tensor(s0), pcost, 50, 6)
    assert torch.equal(ps, ps2)
