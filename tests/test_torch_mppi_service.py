"""Sampling-based MPC on the served path: ``QuantizedMPPI.draw_noise`` and
``solve_words``, ``MPPIService``, and the benchmark's ``mppi`` kind (its
plain reference, its check and its roofline count), on the CPU at small
sizes (B 8, K 64, H 8).

- ``solve_words`` on drawn noise is bit for bit as many ``step`` calls on
  the same generator; on JAX's noise it is ``pint_tpu``'s chain of
  ``step`` calls, words equal (held as ``test_torch_mppi_nonlinear.py``
  holds one ``step``: the lanes may differ only at .5 ties of the weighted
  mean, and on these seeds none does);
- the service's plans and controls against ``portbench/reference/mppi.py``
  within the configuration's limits, and the harness's check on a short
  run: correct, and not correct for an altered plan, a wrong cold-row
  table, or noise that is stale, zero, shared between plants or of the
  wrong spread, nor for the reference in TF32 in the program's place;
- a non-finite row: a zero control, its plan zero and its noise the
  cold-row table again, the other rows as without it;
- the spans: ``pint.mppi.rollout`` then ``pint.mppi.score`` each update,
  ``pint.mppi.sample`` once a draw;
- ``portbench/mppi_bound.py``'s int32 instructions a candidate step are
  those of a merged map equal to the plain reference's bit for bit, and
  its f32 operations a count of the plain score and weighted mean.
"""

import copy
import functools
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from pint_tpu.models import Unicycle as JUnicycle
from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc.mppi import QuantizedMPPI as JMPPI
from pint_tpu.mpc.mppi import unicycle_goal_cost as j_goal
import pint_tpu_torch as pt
from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc.mppi import QuantizedMPPI, unicycle_goal_cost
from portbench import compare, mppi_bound, run
from portbench.kinds import mppi as kind
from portbench.reference import mppi as ref

ROOT = Path(__file__).resolve().parent.parent
B, K, H, U = 8, 64, 8, 2
GOAL = (0.2, 0.1)
SEED = 2**31 + 1201
CONFIG = json.loads((ROOT / "portbench/configs/mppi_t50.json").read_text())


def _config(**solver):
    config = copy.deepcopy(CONFIG)
    config["solver"].update(horizon=H, samples=K, **solver)
    return config


def _states(seed, n=B):
    box = CONFIG["initial_states"]
    return np.random.default_rng(seed).uniform(box["low"], box["high"], (n, 3))


def _service(**kw):
    return kind.build(_config(**kw), B, "cpu")


def _fixed(x):
    return torch.as_tensor(pt.Unicycle().to_fixed(x.astype(np.float32)))


# -- the update on noise it is handed ------------------------------------------------


@pytest.mark.parametrize("updates", [1, 2, 3])
def test_solve_words_is_successive_steps(updates):
    mppi = QuantizedMPPI(horizon=H, samples=K, device="cpu")
    cost = unicycle_goal_cost(mppi.model, GOAL)
    state = _fixed(_states(updates))
    lanes = np.random.default_rng(7).integers(-127, 128, (B, 2 * H))
    warm = pack_controls(torch.as_tensor(lanes, dtype=torch.int32))
    want = warm
    gen = torch.Generator().manual_seed(11)
    for _ in range(updates):
        want, _ = mppi.step(gen, want, state, cost)
    noise = mppi.draw_noise(torch.Generator().manual_seed(11), B, updates)
    assert noise.dtype == torch.int8 and noise.shape == (B, updates, K, 2 * H)
    assert int(noise.abs().max()) <= 127
    assert torch.equal(mppi.solve_words(warm, state, noise, cost), want)


def test_solve_words_on_jax_noise():
    """Two updates from seeded warm words on JAX's noise equal
    ``pint_tpu``'s two ``step`` calls on the same keys, word for word."""
    jref = JMPPI(JUnicycle(), horizon=H, samples=K)
    keys = jax.random.split(jax.random.PRNGKey(5), U)
    lanes0 = np.random.default_rng(8).integers(-100, 101, (B, 2 * H)).astype(np.int32)
    state = np.asarray(_fixed(_states(9)))
    goal = np.asarray(GOAL, np.float32)
    words = j_pack(jnp.asarray(lanes0))
    for k in keys:
        words, _ = jax.jit(lambda k, w, s: jref.step(k, w, s, j_goal(jref.model,
                                                                     jnp.asarray(goal))))(
            k, words, jnp.asarray(state))
    noise = np.stack([np.asarray(jref._sample_noise(k, B)) for k in keys], 1)
    mppi = QuantizedMPPI(horizon=H, samples=K, device="cpu")
    got = mppi.solve_words(pack_controls(torch.as_tensor(lanes0)), torch.as_tensor(state),
                           torch.as_tensor(noise.astype(np.int8)),
                           unicycle_goal_cost(mppi.model, goal))
    want = np.asarray(words).view(np.int32)
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())


# -- the service against the plain reference -----------------------------------------


def test_service_ticks_match_the_plain_reference():
    """Four ticks of the service, each re-solved by the plain reference
    from the warm state the service held and the states it was sent:
    the carried plans (the reference's shift of its own) and the controls
    within the configuration's limits."""
    svc = _service()
    r = kind.Reference(_config(), "cpu")
    limits = CONFIG["limits"]
    for t in range(4):
        x = _states(20 + t)
        words, noise = svc._warm
        if t == 0:
            z = r.zeros(B)
            assert torch.equal(words, z["words"]) and torch.equal(noise, z["noise"])
        u = svc.solve(x)
        want = r.step(torch.as_tensor(x.astype(np.float32)),
                      {"words": words, "noise": noise})["words"]
        carried = r.lanes(r.shift({"words": want})["words"])
        assert compare._diff_pct(r.lanes(svc._warm[0]), carried) <= limits["plan_diff_pct"]
        lanes = np.rint(u / r.lane_scales).astype(np.int32)
        assert compare._diff_pct(torch.as_tensor(lanes), r.lanes(want)[:, :2]) \
            <= limits["control_diff_pct"]
        assert np.abs(lanes).max() <= 127


def _small(**traffic):
    cell = run.load_cell(ROOT, "mppi_t50-fleet4096")
    cell.config = _config()
    cell.traffic = dict(cell.traffic, batch=B, **traffic)
    return cell


@pytest.fixture
def dense_sampling(monkeypatch):
    """Sample every pair of ticks, so that a short CPU window holds some."""
    monkeypatch.setattr(run, "SAMPLE_PERIOD", 2)


def test_the_check_passes_the_service(dense_sampling):
    keep = {}
    res = run.run_cell(_small(), SEED, 1.0, False, "cpu", keep=keep)
    assert res["correct"], res["checks"]
    assert keep["steps"] and keep["pairs"] and res["failed"] == 0
    assert set(res["checks"]) == set(CONFIG["limits"]) | {"ticks_raised"}
    assert keep["start"]["in"]["noise"].shape == (B, U, K, 2 * H)


def test_the_check_holds_the_reset_of_a_lost_sensor(dense_sampling):
    keep = {}
    res = run.run_cell(_small(fault_share=0.25), SEED, 1.0, False, "cpu", keep=keep)
    assert res["correct"], res["checks"]
    sent = np.concatenate([r["x0"] for r in keep["steps"]])
    assert (~np.isfinite(sent).all(axis=1)).any()


def test_the_tf32_control_fails_the_check():
    """The reference with its weighted mean in TF32 (the control of
    ``portbench/calibrate.py``) in the program's place fails at least one
    limit, on 2,048 seeded problems from cold rows and from seeded warm
    plans and drawn noise."""
    n = 2048
    r = kind.Reference(_config(), "cpu")
    rng = np.random.default_rng(60)
    x = _states(61, n)
    lanes = torch.as_tensor(rng.integers(-60, 61, (n, 2 * H)), dtype=torch.int32)
    noise = QuantizedMPPI(horizon=H, samples=K, device="cpu").draw_noise(
        torch.Generator().manual_seed(62), n, U)
    start = {"x0": x}
    steps = [{"x0": x, "in": {"words": pack_controls(lanes), "noise": noise}}]
    ctl = compare.control_readings(r, start, steps)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert any(ctl[k] > CONFIG["limits"][k] for k in ctl), ctl


def _altered():
    """The kind, its service's solver answering a plan with lane 0 moved
    by one."""

    def build(config, batch, device):
        service = kind.build(config, batch, device)
        orig = service.mppi.solve_words

        @functools.wraps(orig)
        def solve_words(*a, **k):
            lanes = unpack_controls(orig(*a, **k))
            lanes[:, 0] = torch.where(lanes[:, 0] < 127, lanes[:, 0] + 1, lanes[:, 0] - 1)
            return pack_controls(lanes)

        object.__setattr__(service.mppi, "solve_words", solve_words)
        return service

    return build


def _wrong_table():
    """The kind, its service's cold-row table drawn from another seed."""

    def build(config, batch, device):
        bad = copy.deepcopy(config)
        bad["solver"]["noise_seed"] += 1
        return kind.build(bad, batch, device)

    return build


def _noise_fault(fault):
    """The kind, its service's draws of the next tick's noise made stale
    (the first draw handed out again every tick), zero, shared by every
    plant (row 0's), or of half the spread."""

    def build(config, batch, device):
        service = kind.build(config, batch, device)
        orig, first = service.mppi.draw_noise, []

        def draw_noise(gen, b, u):
            noise = orig(gen, b, u)
            first[:] = first or [noise]
            return {"stale": first[0], "zero": torch.zeros_like(noise),
                    "shared": noise[:1].expand_as(noise).clone(),
                    "spread": torch.div(noise, 2, rounding_mode="trunc")}[fault]

        object.__setattr__(service.mppi, "draw_noise", draw_noise)
        return service

    return build


@pytest.mark.parametrize("fault", ["altered_plan", "wrong_cold_table", "stale_noise",
                                   "zero_noise", "shared_noise", "spread_noise"])
def test_the_check_fails_a_broken_service(fault, dense_sampling):
    cell = _small()
    members = {k: getattr(kind, k) for k in dir(kind) if not k.startswith("__")}
    build = {"altered_plan": _altered, "wrong_cold_table": _wrong_table}.get(
        fault, lambda: _noise_fault(fault.split("_")[0]))()
    cell.kind = types.SimpleNamespace(**dict(members, build=build))
    res = run.run_cell(cell, SEED, 1.0, False, "cpu")
    assert not res["correct"], res["checks"]
    keys = {"altered_plan": ["plan_diff_pct"], "wrong_cold_table": ["start_diff_pct"]}.get(
        fault, ["plan_diff_pct", "control_diff_pct"])
    for key in keys:
        assert res["checks"][key]["value"] > res["checks"][key]["limit"], res["checks"]


def test_fresh_rows_tells_a_draw_from_stale_or_degenerate_noise():
    """The reference's test of the noise on one call: the service's own
    ticks and cold rows pass; a row of another's noise, of the table on
    warm words, of zeros, of half the spread or with a -128 does not, nor
    the row whose noise another row took."""
    svc = _service()
    pr = kind.Reference(_config(), "cpu").pr
    ticks = []
    for t in range(3):
        ticks.append(svc._warm)
        svc.solve(_states(70 + t))
    words = torch.cat([w for w, _ in ticks])
    noise = torch.cat([n for _, n in ticks])
    assert ref.fresh_rows(pr, words, noise).all()
    assert ref.fresh_rows(pr, words[:B], noise[:B]).all()            # cold rows
    bad = {1: noise[B + 5], 2: pr.table, 3: torch.zeros_like(pr.table),
           4: torch.div(noise[B + 4], 2, rounding_mode="trunc")}
    planted = noise.clone()
    for i, v in bad.items():
        planted[B + i] = v
    planted[2 * B, 1, 3, 5] = -128
    want = torch.ones(3 * B, dtype=torch.bool)
    want[[B + 1, B + 2, B + 3, B + 4, B + 5, 2 * B]] = False
    assert torch.equal(ref.fresh_rows(pr, words, planted), want)


def test_nonfinite_row_resets_to_the_cold_table():
    clean, dirty = _service(), _service()
    x = _states(30)
    for svc in (clean, dirty):
        svc.solve(x)
    table = dirty._zero[1][0]
    assert not torch.equal(dirty._warm[1][1], table)
    bad = x.copy()
    bad[1] = [np.nan, 0.0, np.inf]
    u_clean, u_dirty = clean.solve(x), dirty.solve(bad)
    assert dirty.stats.resets == 1 and clean.stats.resets == 0
    np.testing.assert_array_equal(u_dirty[1], 0.0)
    assert int(dirty._warm[0][1].abs().max()) == 0
    assert torch.equal(dirty._warm[1][1], table)
    keep = [0, *range(2, B)]
    np.testing.assert_array_equal(u_dirty[keep], u_clean[keep])
    for d, c in zip(dirty._warm, clean._warm):
        assert torch.equal(d[keep], c[keep])
    dirty.reset()
    assert all(torch.equal(w, z) for w, z in zip(dirty._warm, dirty._zero))


# -- the spans ------------------------------------------------------------------------


def _mppi_spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ev = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("pint.mppi.")]
    assert not any(e.is_user_annotation() for e in ev)
    return [e.name() for e in sorted(ev, key=lambda e: e.start_ns())]


def test_spans_once_each_per_update_in_order():
    svc = _service()
    svc.solve(_states(40))
    tick = ["pint.mppi.rollout", "pint.mppi.score"] * U + ["pint.mppi.sample"]
    assert _mppi_spans(lambda: svc.solve(_states(41))) == tick
    mppi = svc.mppi
    words, state = mppi.init_words(B), _fixed(_states(42))
    cost = unicycle_goal_cost(mppi.model, GOAL)
    gen = torch.Generator().manual_seed(1)
    assert _mppi_spans(lambda: [mppi.step(gen, words, state, cost) for _ in range(3)]) == \
        ["pint.mppi.sample", "pint.mppi.rollout", "pint.mppi.score"] * 3


# -- the roofline's count -------------------------------------------------------------


class _Count(TorchFunctionMode):
    """Operations of the torch calls made inside: one an elementwise result
    (a clamp two, a max and a min), n - 1 a sum of n, 2 a multiply-add of
    a batched product; views, stacks and indexing none."""

    ONE = {"add", "sub", "__rsub__", "mul", "pow", "neg", "__rshift__", "__lshift__",
           "__and__", "__eq__", "where", "to"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in self.ONE:
            self.ops += out.numel()
        elif name == "clamp":
            self.ops += 2 * out.numel()
        elif name == "sum":
            self.ops += args[0].numel() - out.numel()
        elif name == "bmm":
            a, b = args
            self.ops += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        return out


def _count(fn, *args):
    with _Count() as c:
        fn(*args)
    return c.ops


def test_roofline_counts_equal_the_plain_maps():
    """The int32 count is the fewest instructions of the plain map: its
    merged form equals the map bit for bit on every angle and lane, the
    lane adds count as the plain reference's, and the classes sum to the
    count; the f32 count is a count of the plain score and mean."""
    rng = np.random.default_rng(50)
    n = 1000
    pr = ref.MPPIProblem({**CONFIG["model"], **_config()["solver"]}, "cpu")
    lanes = [torch.as_tensor(rng.integers(-127, 128, n), dtype=torch.int32) for _ in range(2)]
    adds = _count(ref.saturating_add, torch.stack(lanes, -1), torch.stack(lanes[::-1], -1)) / n
    assert adds == 6
    m = CONFIG["model"]
    th = torch.arange(-2**17, 2**17, dtype=torch.int32)
    x, y = (torch.as_tensor(rng.integers(-2**30, 2**30, th.numel()), dtype=torch.int32)
            for _ in range(2))
    for v, w in ((-128, 127), (127, -128), (-1, 1), (37, -90)):
        vs, ws = torch.full_like(th, v), torch.full_like(th, w)
        plain = ref.q16_step(pr, x, y, th, vs, ws)
        merged = mppi_bound.merged_step(x, y, th, vs, ws, m["dt_shift"], m["v_shift"],
                                        m["w_shift"])
        assert all(torch.equal(a, b) for a, b in zip(plain, merged)), (v, w)
    assert mppi_bound.INT_OPS_PER_STEP == sum(mppi_bound.INT_ALU_PER_STEP.values()) == 22
    assert mppi_bound.INT_ALU_PER_STEP["min_max"] + 2 == adds       # 2 adds, 4 clamps
    assert mppi_bound.IMAD_PER_STEP == 4

    def score_ops(T):
        states = torch.as_tensor(rng.integers(-2**17, 2**17, (n, T + 1, 3)), dtype=torch.int32)
        return _count(ref.costs, pr, states, torch.zeros((n, 2 * T), dtype=torch.int32)) / n

    per_step = score_ops(H + 1) - score_ops(H)
    w = torch.full((4, K), 1.0 / K)
    cand = torch.as_tensor(rng.integers(-127, 128, (4, K, 2 * H)), dtype=torch.int32)
    mean = _count(lambda: torch.bmm(w[:, None, :], cand.to(torch.float32))) \
        - 4 * K * 2 * H                                           # the conversion
    assert mppi_bound.F32_OPS_PER_STEP == per_step + mean / (4 * K * H) == 20
    # the cell's bound: int32-bound, about a quarter of a millisecond a tick
    ms = mppi_bound.update_bound_ms(4096, 2, 512, 50)
    assert ms == pytest.approx(1e3 * 4096 * 2 * 512 * 50 * 22 / mppi_bound.INT32_PER_S)
    assert 0.25 < ms < 0.3
