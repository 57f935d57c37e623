"""The MPPI update's kernel path on the CPU: its plain version
(``mppi_update_plain``, the kernel's order of roundings) against the torch
update (``QuantizedMPPI._update``), the rule that chooses the kernel, and the
goal cost as an object.

- the candidates and the rollouts of the merged map are the torch update's
  bit for bit; the costs agree to float32 roundoff (rtol (T + 2) 2**-24:
  sums of T + 2 non-negative terms in another order); the words agree but
  for lanes whose weighted mean lies within float32 roundoff of a .5 (each
  off by one, its float64 mean within 1e-3 of the .5, and at most 0.5% of
  the lanes);
- the kernel path is taken only for ``Unicycle`` itself with mergeable
  shifts, the goal cost of ``unicycle_goal_cost`` with one goal, K a power
  of two in [32, 1024], an even horizon, the slab in shared memory, and
  words on the card; everything else runs the torch update;
- ``UnicycleGoalCost`` gives the closure's results bit for bit.

No card is needed: a tensor on the card is stood in for by an object with a
CUDA device where only the device is read.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import pint_tpu_torch as pt
from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc import mppi as M
from pint_tpu_torch.mpc.mppi import (QuantizedMPPI, UnicycleGoalCost, mppi_update_fused,
                                     mppi_update_plain, unicycle_goal_cost, update_fits)

GOAL = (0.2, 0.1)
BOX = ([-0.2, -0.2, 0.0], [0.2, 0.2, 1.0])
ON_CARD = types.SimpleNamespace(device=torch.device("cuda"))


def _problem(B, K, H, seed, warm=60):
    """A solver on the CPU, seeded start states in the cells' box, warm
    words in [-warm, warm] and one update's noise."""
    mppi = QuantizedMPPI(horizon=H, samples=K, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.uniform(*BOX, (B, 3)).astype(np.float32)
    state = torch.as_tensor(pt.Unicycle().to_fixed(x))
    lanes = torch.as_tensor(rng.integers(-warm, warm + 1, (B, 2 * H)), dtype=torch.int32)
    noise = mppi.draw_noise(torch.Generator().manual_seed(seed), B, 1)[:, 0]
    return mppi, pack_controls(lanes), state, noise


def _closure(model, goal_xy):
    """``unicycle_goal_cost`` as it was written before it became a class."""
    goal_t = torch.as_tensor(goal_xy if isinstance(goal_xy, torch.Tensor)
                             else np.asarray(goal_xy), dtype=torch.float32)

    def cost(states, controls):
        xy = states[..., :2].to(torch.float32) * float(np.float32(2.0**-model.frac_bits))
        goal = goal_t.to(xy.device)[..., None, :]
        d2 = torch.sum((xy - goal) ** 2, dim=-1)
        run = torch.sum(d2[..., 1:], dim=-1)
        term = 20.0 * d2[..., -1]
        effort = 1e-4 * torch.sum(controls.to(torch.float32) ** 2, dim=(-2, -1))
        return run + term + effort

    return cost


# -- the plain version against the torch update ---------------------------------------


@pytest.mark.parametrize("B,K,H,seed", [(16, 64, 8, 1), (8, 512, 50, 2), (24, 32, 12, 3),
                                        (4, 1024, 20, 4)])
def test_rollouts_and_costs_against_the_torch_update(B, K, H, seed):
    mppi, words, state, noise = _problem(B, K, H, seed)
    cost = unicycle_goal_cost(mppi.model, GOAL)
    lanes, ctrl, states = mppi._rollouts(words, noise.to(torch.int32), state)
    cand = unpack_controls(M.W.add_signed_saturate(M.CONTROL_LAYOUT, words[:, None, :],
                                                   pack_controls(noise)))
    assert torch.equal(cand, lanes)
    assert torch.equal(cand, torch.clamp(unpack_controls(words)[:, None, :]
                                         + noise.to(torch.int32), -128, 127))
    xs, ws = M.merged_shifts(mppi.model)
    x, y, th = (state[:, i, None].expand(B, K) for i in range(3))
    for k in range(H):
        x, y, th = M._merged_step(x, y, th, lanes[..., 2 * k], lanes[..., 2 * k + 1], xs, ws)
        assert torch.equal(torch.stack([x, y, th], -1), states[:, :, k + 1])
    got = M._costs_plain(mppi.model, cost, state, lanes)
    want = cost(states, ctrl)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=(H + 2) * 2.0**-24, atol=0.0)


@pytest.mark.parametrize("B,K,H,seed", [(64, 64, 8, 5), (32, 512, 50, 6), (48, 128, 16, 7),
                                        (16, 1024, 10, 8)])
def test_plain_update_against_the_torch_update(B, K, H, seed):
    mppi, words, state, noise = _problem(B, K, H, seed)
    cost = unicycle_goal_cost(mppi.model, GOAL)
    want, want_best = mppi._update(words, noise, state, cost)
    got, best = mppi_update_plain(mppi, words, noise, state, cost)
    torch.testing.assert_close(best, want_best, rtol=(H + 2) * 2.0**-24, atol=0.0)
    a, b = unpack_controls(got), unpack_controls(want)
    off = a != b
    assert int(off.sum()) <= 0.005 * off.numel(), int(off.sum())
    if off.any():
        assert int((a - b)[off].abs().max()) == 1
        # the weighted mean in float64 from the plain version's own weights
        lanes = unpack_controls(M.W.add_signed_saturate(
            M.CONTROL_LAYOUT, words[:, None, :], pack_controls(noise))).to(torch.float64)
        c = M._costs_plain(mppi.model, cost, state, lanes.to(torch.int32))
        mu = c.amin(-1, keepdim=True)
        z = -(c - mu) / ((M._median(c) - mu + 1e-6) * mppi.temperature)
        mean = torch.einsum("bk,bkl->bl", torch.softmax(z.double(), -1), lanes)
        frac = (mean - torch.floor(mean))[off]
        assert float((frac - 0.5).abs().max()) < 1e-3


def test_plain_update_keeps_the_box():
    """Nominal lanes and noise at +-127: every candidate lane saturates to
    [-128, 127] and every new lane stays in [-127, 127]."""
    B, K, H = 8, 64, 8
    mppi = QuantizedMPPI(horizon=H, samples=K, device="cpu")
    rng = np.random.default_rng(9)
    lanes = torch.as_tensor(rng.choice([-127, 127], (B, 2 * H)), dtype=torch.int32)
    noise = torch.as_tensor(rng.choice([-127, 127], (B, K, 2 * H)), dtype=torch.int8)
    state = torch.zeros((B, 3), dtype=torch.int32)
    cost = unicycle_goal_cost(mppi.model, GOAL)
    got, _ = mppi_update_plain(mppi, pack_controls(lanes), noise, state, cost)
    want, _ = mppi._update(pack_controls(lanes), noise, state, cost)
    new = unpack_controls(got)
    assert int(new.abs().max()) <= 127
    assert int((new != unpack_controls(want)).sum()) <= 0.005 * new.numel()


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    mppi, words, state, noise = _problem(8, 64, 8, 10)
    cost = unicycle_goal_cost(mppi.model, GOAL)
    pt.ops.kernels.reset_launch_counts()
    got = mppi_update_fused(mppi, words, noise.to(torch.int32), state, cost)
    want = mppi_update_plain(mppi, words, noise, state, cost)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert M.launch_count() == 0


# -- the rule that chooses the kernel -------------------------------------------------


class _SubUnicycle(pt.Unicycle):
    pass


class _SubCost(UnicycleGoalCost):
    pass


def test_the_kernel_path_is_chosen_for_the_goal_cost_on_the_card():
    mppi = QuantizedMPPI(device="cpu")
    cost = unicycle_goal_cost(mppi.model, GOAL)
    assert mppi._fused(ON_CARD, cost)
    assert mppi._fused(ON_CARD, unicycle_goal_cost(mppi.model, torch.tensor([[0.2, 0.1]])))
    assert not mppi._fused(mppi.init_words(4), cost)                       # on the CPU


@pytest.mark.parametrize("why", ["closure", "subclassed_cost", "lambda", "per_problem_goal",
                                 "subclassed_model", "v_shift_1", "w_below_dt",
                                 "k_not_a_power_of_two", "k_16", "k_2048", "odd_horizon",
                                 "slab_past_shared_memory"])
def test_the_torch_path_everywhere_else(why):
    model, kw = pt.Unicycle(), {}
    if why == "subclassed_model":
        model = _SubUnicycle()
    elif why == "v_shift_1":
        model = pt.Unicycle(v_shift=1)
    elif why == "w_below_dt":
        model = pt.Unicycle(w_shift=4)
    kw = {"k_not_a_power_of_two": dict(samples=96), "k_16": dict(samples=16),
          "k_2048": dict(samples=2048), "odd_horizon": dict(horizon=49),
          "slab_past_shared_memory": dict(samples=1024, horizon=120)}.get(why, {})
    mppi = QuantizedMPPI(model, device="cpu", **kw)
    cost = {"closure": _closure(model, GOAL), "subclassed_cost": _SubCost(model, GOAL),
            "lambda": lambda s, c: unicycle_goal_cost(model, GOAL)(s, c),
            "per_problem_goal": unicycle_goal_cost(model, np.zeros((4, 1, 2), np.float32))
            }.get(why, unicycle_goal_cost(model, GOAL))
    assert not mppi._fused(ON_CARD, cost)
    with pytest.raises(ValueError):
        M._check_update(mppi, torch.zeros((4, mppi.words_per_plan), dtype=torch.int32),
                        torch.zeros((4, mppi.samples, mppi.lanes_per_plan), dtype=torch.int8),
                        torch.zeros((4, 3), dtype=torch.int32), cost)


@pytest.mark.parametrize("samples,horizon,fits", [(512, 50, True), (1024, 100, True),
                                                  (1024, 112, False), (32, 2, True),
                                                  (256, 0, False)])
def test_update_fits_at_its_edges(samples, horizon, fits):
    assert update_fits(pt.Unicycle(), samples, horizon) is fits


def test_the_torch_update_runs_unchanged_on_the_cpu(monkeypatch):
    """On CPU tensors the goal cost takes the torch update, never the kernel's
    wrapper; its words are as many ``step`` calls' (held further in
    ``test_torch_mppi_service.py``)."""
    def no_kernel(*a, **k):
        raise AssertionError("the kernel path ran on the CPU")

    monkeypatch.setattr(M, "mppi_update_fused", no_kernel)
    mppi, words, state, noise = _problem(8, 64, 8, 11)
    cost = unicycle_goal_cost(mppi.model, GOAL)
    got, best = mppi._update(words, noise, state, cost)
    lanes, ctrl, states = mppi._rollouts(words, noise, state)
    assert torch.equal(best, torch.amin(cost(states, ctrl), dim=-1))


# -- the merged map ---------------------------------------------------------------------


@pytest.mark.parametrize("shifts", [(5, 8, 6), (5, 10, 8), (5, 2, 5), (16, 10, 23), (1, 3, 1)])
def test_the_merged_step_is_the_models_map(shifts):
    dt, vs, ws = shifts
    model = pt.Unicycle(dt_shift=dt, v_shift=vs, w_shift=ws)
    xs_ws = M.merged_shifts(model)
    assert xs_ws is not None
    rng = np.random.default_rng(dt + vs + ws)
    th = torch.arange(-2**17, 2**17, 7, dtype=torch.int32)
    th = torch.cat([th, torch.tensor([2**31 - 1, -2**31, 2**31 - 2**14, 0x7FFF, 0x8000])
                    .to(torch.int32)])
    x, y = (torch.as_tensor(rng.integers(-2**31, 2**31, th.numel()), dtype=torch.int32)
            for _ in range(2))
    for v, w in ((-128, 127), (127, -128), (-1, 1), (0, 0), (37, -90)):
        vs_t, ws_t = torch.full_like(th, v), torch.full_like(th, w)
        want = model.step(torch.stack([x, y, th], -1), vs_t, ws_t)
        got = torch.stack(M._merged_step(x, y, th, vs_t, ws_t, *xs_ws), -1)
        assert torch.equal(got, want), (v, w)


# -- the goal cost as an object ---------------------------------------------------------


@pytest.mark.parametrize("goal", ["tuple", "tensor", "per_problem", "row"])
def test_goal_cost_object_is_the_closure(goal):
    model = pt.Unicycle()
    rng = np.random.default_rng(12)
    B, K, T = 6, 10, 9
    g = {"tuple": GOAL, "tensor": torch.tensor(GOAL),
         "per_problem": rng.uniform(-1, 1, (B, 1, 2)).astype(np.float32),
         "row": np.asarray([GOAL], np.float32)}[goal]
    states = torch.as_tensor(rng.integers(-2**20, 2**20, (B, K, T + 1, 3)), dtype=torch.int32)
    ctrl = torch.as_tensor(rng.integers(-128, 128, (B, K, T, 2)), dtype=torch.int32)
    obj, fn = unicycle_goal_cost(model, g), _closure(model, g)
    assert isinstance(obj, UnicycleGoalCost) and obj.frac_bits == model.frac_bits
    assert torch.equal(obj(states, ctrl), fn(states, ctrl))
    assert (obj.shared_goal is None) == (goal == "per_problem")
    if obj.shared_goal is not None:
        assert obj.shared_goal == tuple(np.float32(GOAL).tolist())


def test_solver_copies_keep_the_rule():
    mppi = QuantizedMPPI(device="cpu")
    assert dataclasses.replace(mppi, samples=96)._fits is False
    assert dataclasses.replace(mppi, horizon=40)._fits is True
