"""Port parity: every condensation form of DeviceSQP and
DeviceConstrainedSQP (``propagate`` "unroll", "scan", "allpairs", "auto";
``reduce`` "sym", "einsum", "blocked", "btrans") against pint_tpu's same
form on the same inputs, on the unicycle (n = 3), the pendulum (n = 2) and
the planar quadrotor (n = 6, m = 2).

Tolerances, those of tests/test_device_sqp.py's cross-path checks:
* the port's recursion, which "scan" runs, rtol 1e-6, atol 1e-6 against
  JAX's scan stacks;
* the allpairs (H, g) within 1e-4 of max|.| of the recursion's and of
  JAX's allpairs; its pieces (Gauss-Jordan inverse, the log-depth prefix
  products) rtol 1e-5, atol 1e-6 against JAX's;
* each reduce form's (Ht, g) on JAX's own stacks: Ht within 1e-5 of
  max|Ht|, g rtol 1e-5, atol 1e-4;
* whole solves at cost parity (rtol 0.01, atol 1e-4) and, constrained,
  violation parity (atol 5e-3): last-ulp f32 differences can move an int8
  rounding tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models import Pendulum as JPendulum
from pint_tpu.models import PlanarQuadrotor as JQuad
from pint_tpu.mpc import DeviceConstrainedSQP as JDeviceConstrainedSQP
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu.mpc.device_sqp import _inv_unrolled as j_inv
from pint_tpu_torch.convert import (
    device_constrained_config,
    device_sqp_config,
    words_from_numpy,
)
from pint_tpu_torch.models import Pendulum, PlanarQuadrotor
from pint_tpu_torch.models.dynamics import unpack_controls
from pint_tpu_torch.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_tpu_torch.mpc.device_sqp import _assoc_scan, _inv_unrolled

UNI = dict(horizon=16, sqp_iters=2, pgd_iters=10, Q=np.diag([1.0, 1.0, 0.005]),
           R=np.diag([0.005, 0.005]), qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]))
PEND = dict(horizon=16, sqp_iters=2, pgd_iters=10, Q=np.diag([1.0, 0.05]),
            R=np.array([[0.05]]), x_ref=np.zeros(2))
QUAD = dict(horizon=16, sqp_iters=4, pgd_iters=30, Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
            R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6))
MODELS = {"unicycle": (None, UNI, 3), "pendulum": (JPendulum, PEND, 2),
          "quadrotor": (JQuad, QUAD, 6)}


def _ref(name, **kw):
    cls, base, _ = MODELS[name]
    kw = dict(base, **kw)
    if cls is not None:
        kw["model"] = cls()
    return JDeviceSQP(**kw)


def _inputs(name, B, seed, ref):
    n = MODELS[name][2]
    rng = np.random.default_rng(seed)
    x0 = (rng.normal(size=(B, n)) * 0.2).astype(np.float32)
    lanes = rng.integers(-40, 40, (B, ref.n_dec), dtype=np.int32)
    return x0, lanes


def _t(a):
    return torch.as_tensor(np.array(a))


def _close_to_max(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rel * (np.abs(b).max() + 1e-12)


def _lanes(sqp, words):
    return unpack_controls(words)[:, : sqp.n_dec].cpu().numpy().astype(np.float64)


# -- the pieces ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 6])
def test_inv_unrolled_matches_jax(n):
    rng = np.random.default_rng(n)
    M = (np.eye(n) + 0.05 * rng.normal(size=(5, 7, n, n))).astype(np.float32)
    got = _inv_unrolled(_t(M))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_inv(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy() @ M, np.broadcast_to(np.eye(n), M.shape),
                               atol=1e-5)


@pytest.mark.parametrize("T", [1, 2, 5, 16, 33])
def test_assoc_scan_is_the_reference_product_tree(T):
    """Prefix products in jax.lax.associative_scan's combine order: both
    directions of the matrix product, rtol 1e-5."""
    rng = np.random.default_rng(T)
    A = (np.eye(3) + 0.1 * rng.normal(size=(4, T, 3, 3))).astype(np.float32)
    for comb in (lambda x, y: y @ x, lambda x, y: x @ y):
        want = jax.lax.associative_scan(comb, jnp.asarray(A), axis=1)
        np.testing.assert_allclose(_assoc_scan(comb, _t(A)).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", params=list(MODELS))
def linearized(request):
    """JAX's linearization of a warm plan, its scan stacks, and both
    solvers."""
    name = request.param
    ref = _ref(name, propagate="scan")
    port = device_sqp_config(ref, device="cpu")
    x0, lanes = _inputs(name, 6, 31, ref)
    lin = [np.asarray(v) for v in jax.jit(ref._linearize_phase)(jnp.asarray(x0),
                                                                 jnp.asarray(lanes))]
    stacks = [np.asarray(v) for v in jax.jit(ref._propagate_scan)(*lin)]
    return name, ref, port, x0, lanes, lin, stacks


def _batch_first(stacks):
    """JAX's batch-last stacks (T, n, ..., B) -> the port's (B, T, n, ...)."""
    return [np.moveaxis(s, -1, 0) for s in stacks]


def test_propagate_scan_matches(linearized):
    """``propagate="scan"`` runs the port's recursion; its stacks against
    JAX's scan, rtol 1e-6, atol 1e-6 (as tests/test_device_sqp.py holds
    unroll against scan)."""
    _, _, port, _, _, lin, stacks = linearized
    assert (port.propagate, port._propagate_mode()) == ("scan", "unroll")
    got = port._propagate_unrolled(*(_t(v) for v in lin))
    for a, b in zip(got, _batch_first(stacks)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)


def test_allpairs_agrees(linearized):
    """allpairs (H, g) within 1e-4 of max of the recursion's (the
    reference's test_propagate_paths_agree bound) and of JAX's allpairs on
    the same inputs; the quadrotor runs the Gauss-Jordan inverse at n = 6."""
    name, ref, port, x0, lanes, _, _ = linearized
    ap = dataclasses.replace(port, propagate="allpairs")
    got = ap._condense_hg(_t(x0), _t(lanes))
    rec = port._condense_hg(_t(x0), _t(lanes))
    j_ap = jax.jit(dataclasses.replace(ref, propagate="allpairs")._condense_hg)(
        jnp.asarray(x0), jnp.asarray(lanes))
    for a, b, c in zip(got, rec, j_ap):
        _close_to_max(a.numpy(), b.numpy(), 1e-4)
        _close_to_max(a.numpy(), np.asarray(c), 1e-4)


@pytest.mark.parametrize("reduce", ["einsum", "blocked", "btrans", "sym"])
def test_reduce_forms_match_jax(linearized, reduce):
    """Each contraction on JAX's own stacks against JAX's same form."""
    _, ref, port, x0, _, _, stacks = linearized
    r = dataclasses.replace(ref, reduce=reduce)
    p = dataclasses.replace(port, reduce=reduce)
    fn = {"einsum": r._reduce_phase, "blocked": r._reduce_blocked,
          "btrans": r._reduce_btrans, "sym": r._reduce_sym}[reduce]
    Ht_j, g_j = (np.asarray(v) for v in jax.jit(fn)(*(jnp.asarray(s) for s in stacks),
                                                      jnp.asarray(x0)))
    Ht, g = p._reduce(*(_t(s) for s in _batch_first(stacks)), _t(x0))
    assert Ht.shape == Ht_j.shape
    _close_to_max(Ht.numpy(), Ht_j, 1e-5)
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5, atol=1e-4)
    if reduce == "blocked":   # the off-diagonal blocks are exact transposes
        h = (p.horizon // 2) * p.n_ctrl
        assert torch.equal(Ht[:h, h:], Ht[h:, :h].transpose(0, 1))


# -- the solvers -----------------------------------------------------------------------


FORMS = [dict(propagate=p) for p in ("unroll", "scan", "allpairs", "auto")] + [
    dict(reduce=r) for r in ("einsum", "blocked", "btrans")]


@pytest.fixture(scope="module")
def uni_default():
    ref = _ref("unicycle")
    x0, _ = _inputs("unicycle", 4, 41, ref)
    w, _ = ref.solve(x0.astype(np.float64))
    port = device_sqp_config(ref, device="cpu")
    return ref, port, x0, port.true_cost(x0, _lanes(port, words_from_numpy(
        np.asarray(w), device="cpu")))


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
def test_device_sqp_forms_at_cost_parity(uni_default, form):
    """Every form's whole solve at cost parity with JAX's default (unroll
    + sym) solve."""
    ref, _, x0, cost_ref = uni_default
    port = device_sqp_config(dataclasses.replace(ref, **form), device="cpu")
    w, plans = port.solve(x0)
    assert np.isfinite(plans).all()
    np.testing.assert_allclose(port.true_cost(x0, _lanes(port, w)), cost_ref,
                               rtol=0.01, atol=1e-4)


def test_einsum_takes_an_indefinite_q():
    """reduce="einsum" builds and solves with an indefinite Q, where "sym"
    refuses it."""
    kw = dict(UNI, Q=np.diag([1.0, 1.0, -0.001]), device="cpu")
    with pytest.raises(ValueError, match="einsum"):
        DeviceSQP(**kw)
    sqp = DeviceSQP(**kw, reduce="einsum")
    words, plans = sqp.solve(_inputs("unicycle", 2, 5, sqp)[0])
    assert words.shape == (2, sqp.n_dec // 4) and np.isfinite(plans).all()


@pytest.mark.parametrize("horizon", [8, 16, 24, 40, 64])
def test_auto_resolution(horizon):
    """"auto" and "scan" resolve to the recursion ("unroll") at every
    horizon; "allpairs" is kept."""
    sqp = DeviceSQP(**dict(UNI, horizon=horizon), device="cpu")
    assert sqp._propagate_mode() == "unroll"
    for mode, want in (("scan", "unroll"), ("allpairs", "allpairs"), ("unroll", "unroll")):
        assert dataclasses.replace(sqp, propagate=mode)._propagate_mode() == want


CON = dict(F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=2)


@pytest.fixture(scope="module")
def con_default():
    kw = dict(UNI, x_ref=np.array([1.0, 0.0, 0.0]))
    ref = JDeviceConstrainedSQP(JDeviceSQP(**kw), **CON)
    x0 = np.array([[0.0, 0.0, 0.0], [-0.1, 0.02, 0.05], [0.1, -0.02, 0.9]], np.float32)
    w, _ = ref.solve_words(ref.init_words(3), x0)
    port = device_constrained_config(ref, device="cpu")
    lanes = _lanes(port.dev, words_from_numpy(np.asarray(w), device="cpu"))
    return ref, x0, port.dev.true_cost(x0, lanes), port.violation(x0, lanes)


@pytest.mark.parametrize("form", FORMS, ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
def test_device_constrained_forms_at_parity(con_default, form):
    """The constrained condensation honours dev.propagate and dev.reduce;
    each form's solve at cost and violation parity with JAX's default."""
    ref, x0, cost_ref, viol_ref = con_default
    port = device_constrained_config(
        dataclasses.replace(ref, dev=dataclasses.replace(ref.dev, **form)), device="cpu")
    w, lam = port.solve_words(port.init_words(3), x0)
    lanes = _lanes(port.dev, w)
    np.testing.assert_allclose(port.dev.true_cost(x0, lanes), cost_ref, rtol=0.01,
                               atol=1e-4)
    np.testing.assert_allclose(port.violation(x0, lanes), viol_ref, atol=5e-3)


# -- the planar quadrotor and the pendulum through the device tiers ------------------


QUAD_X0 = np.array([[0.3, -0.2, 0.01, 0.0, 0.0, 0.0],
                    [-0.2, 0.1, -0.02, 0.1, -0.1, 0.02],
                    [0.0, 0.3, 0.03, -0.1, 0.0, -0.03]])


@pytest.fixture(scope="module")
def quad_pair():
    from pint_tpu.mpc import QuantizedSQP

    kw = dict(QUAD, model=JQuad())
    return QuantizedSQP(**kw), JDeviceSQP(**kw)


def test_quadrotor_device_matches_host_path(quad_pair):
    """tests/test_quadrotor_device.py::test_device_matches_host_path: the
    port's solve against JAX's f64 host path (QuantizedSQP) in true cost."""
    host, ref = quad_pair
    _, host_costs = host.solve(QUAD_X0)
    port = device_sqp_config(ref, device="cpu")
    w, _ = port.solve(QUAD_X0)
    dev_costs = host.true_cost(QUAD_X0, _lanes(port, w))
    np.testing.assert_allclose(dev_costs, host_costs[:, -1], rtol=0.01, atol=1e-4)
    # and against JAX's own device solve
    w_j, _ = ref.solve(QUAD_X0)
    lanes_j = _lanes(port, words_from_numpy(np.asarray(w_j), device="cpu"))
    np.testing.assert_allclose(dev_costs, host.true_cost(QUAD_X0, lanes_j), rtol=0.01,
                               atol=1e-4)


def test_quadrotor_regulates_and_is_deterministic(quad_pair):
    host, ref = quad_pair
    port = device_sqp_config(ref, device="cpu")
    assert port.forms == dict(chain="torch", condense="lipq", inner="pgd_hqt")
    w1, _ = port.solve(QUAD_X0)
    w2, _ = port.solve(QUAD_X0)
    assert torch.equal(w1, w2)
    cost = host.true_cost(QUAD_X0, _lanes(port, w1))
    zero = host.true_cost(QUAD_X0, np.zeros((3, port.n_dec)))
    assert (cost < 0.92 * zero).all(), (cost, zero)


def test_quadrotor_allpairs_within_one_lane_of_scan():
    """tests/test_quadrotor_device.py::test_allpairs_agrees_at_n6: the
    solves land within one int8 lane step."""
    kw = dict(QUAD, sqp_iters=2, pgd_iters=10, model=PlanarQuadrotor(), device="cpu")
    d_ap = DeviceSQP(**kw, propagate="allpairs")
    d_sc = DeviceSQP(**kw, propagate="scan")
    rng = np.random.default_rng(3)
    x = _t((rng.normal(size=(4, 6)) * 0.2).astype(np.float32))
    l_ap = _lanes(d_ap, d_ap.solve_words(d_ap.init_words(4), x))
    l_sc = _lanes(d_sc, d_sc.solve_words(d_sc.init_words(4), x))
    assert np.abs(l_ap - l_sc).max() <= 1


def test_quadrotor_constrained_corridor():
    """tests/test_quadrotor_device.py::test_device_constrained_corridor: a
    binding |vy| corridor held on the true rollout, deterministically, at
    violation parity with JAX's solve."""
    kw = dict(QUAD, model=JQuad())
    ref = JDeviceConstrainedSQP(JDeviceSQP(**kw), F=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]],
                                lo=-0.15, hi=0.15, rho=50.0, alm_outer=3)
    port = device_constrained_config(ref, device="cpu")
    assert port.padded_rows == 64 and port.n_rows == 16
    x0 = QUAD_X0.astype(np.float32)
    w_u = port.dev.solve_words(port.init_words(3), x0)
    assert port.violation(x0, _lanes(port.dev, w_u)).max() > 0.02   # it binds
    w, lam = port.solve_words(port.init_words(3), x0)
    viol = port.violation(x0, _lanes(port.dev, w))
    assert viol.max() < 0.01 and int(lam.abs().max()) > 0
    w2, lam2 = port.solve_words(port.init_words(3), x0)
    assert torch.equal(w, w2) and torch.equal(lam, lam2)
    w_j, _ = ref.solve_words(ref.init_words(3), x0)
    lanes_j = _lanes(port.dev, words_from_numpy(np.asarray(w_j), device="cpu"))
    np.testing.assert_allclose(viol, port.violation(x0, lanes_j), atol=5e-3)
    np.testing.assert_allclose(port.dev.true_cost(x0, _lanes(port.dev, w)),
                               port.dev.true_cost(x0, lanes_j), rtol=0.01, atol=1e-4)


def test_pendulum_device_tiers_at_parity():
    """The pendulum at tests/test_device_constrained.py:231's size (T = 32,
    Tm = 32) through both device solvers, at cost parity with JAX's."""
    kw = dict(horizon=32, sqp_iters=3, pgd_iters=30, Q=np.diag([1.0, 0.05]),
              R=np.array([[0.05]]), x_ref=np.zeros(2), model=JPendulum())
    ref = JDeviceSQP(**kw)
    cref = JDeviceConstrainedSQP(ref, F=[[0.0, 1.0]], lo=-0.4, hi=0.4, rho=50.0,
                                 alm_outer=3)
    x0 = np.array([[0.05, 0.0], [-0.08, 0.3], [0.12, -0.2]], np.float32)
    port = device_sqp_config(ref, device="cpu")
    cport = device_constrained_config(cref, device="cpu")
    assert port.n_dec == 32 and cport.padded_rows == 64
    w, _ = port.solve(x0)
    w_j, _ = ref.solve(x0)
    np.testing.assert_allclose(
        port.true_cost(x0, _lanes(port, w)),
        port.true_cost(x0, _lanes(port, words_from_numpy(np.asarray(w_j), device="cpu"))),
        rtol=0.01, atol=1e-4)
    wc, _ = cport.solve_words(cport.init_words(3), x0)
    wc_j, _ = cref.solve_words(cref.init_words(3), x0)
    lanes, lanes_j = _lanes(port, wc), _lanes(port, words_from_numpy(np.asarray(wc_j),
                                                                     device="cpu"))
    np.testing.assert_allclose(port.true_cost(x0, lanes), port.true_cost(x0, lanes_j),
                               rtol=0.01, atol=1e-4)
    np.testing.assert_allclose(cport.violation(x0, lanes), cport.violation(x0, lanes_j),
                               atol=5e-3)


@pytest.mark.parametrize("cls, jcls", [(PlanarQuadrotor, JQuad), (Pendulum, JPendulum)])
def test_convert_takes_both_models(cls, jcls):
    jm = jcls() if jcls is JPendulum else jcls(f_shift=10, torque_shift=3)
    kw = QUAD if jcls is JQuad else PEND
    ref = JDeviceSQP(**dict(kw, model=jm), propagate="scan", reduce="einsum")
    port = device_sqp_config(ref, device="cpu")
    assert type(port.model) is cls
    assert dataclasses.asdict(port.model) == dataclasses.asdict(jm)
    assert (port.propagate, port.reduce) == ("scan", "einsum")
    n = MODELS["quadrotor" if cls is PlanarQuadrotor else "pendulum"][2]
    F = np.eye(n)[1:2]
    cport = device_constrained_config(JDeviceConstrainedSQP(ref, F=F, lo=-1.0, hi=1.0),
                                      device="cpu")
    assert type(cport.dev.model) is cls and cport.n_rows == ref.horizon
