"""Port parity: the serving endpoints (MPCService, RTIService) against
pint_tpu's, plus the port's package boundary.

Tolerances: MPCService with the host linear term (``g_on_device=False``)
returns bit-identical controls over 3 ticks; RTIService plans are held to
cost parity, rtol 0.01, atol 1e-4 (tests/test_device_sqp.py's bound: the
f32 condensation differs from JAX's in the last ulps)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pint_tpu.models.dynamics import unpack_controls as j_unpack
from pint_tpu.mpc import DeviceSQP as JDeviceSQP
from pint_tpu.mpc import QuantizedSQP
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.serving import MPCService as JMPCService
from pint_tpu.serving import RTIService as JRTIService
from pint_tpu_torch import MPCService, RTIService
from pint_tpu_torch.convert import device_sqp_config, quantized_qp_from_arrays
from pint_tpu_torch.models.dynamics import unpack_controls

REPO = Path(__file__).resolve().parent.parent
RTI_KW = dict(
    horizon=32, sqp_iters=1, pgd_iters=30,
    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
)


@pytest.fixture(scope="module")
def qqps():
    ref = j_quantize(j_condense(T=50))
    return ref, quantized_qp_from_arrays(ref)


def _lti_states(rng, b):
    return np.stack([rng.uniform(-3, 3, b), rng.uniform(-1, 1, b)], axis=-1)


@pytest.mark.parametrize("use_fused", [False, True])
def test_mpc_service_bit_identical_over_ticks(qqps, use_fused):
    ref, port = qqps
    b = 16
    jsvc = JMPCService(ref, batch=b, iters_per_tick=15, g_on_device=False,
                       use_fused=False)
    tsvc = MPCService(port, batch=b, iters_per_tick=15, g_on_device=False,
                      use_fused=use_fused)
    rng = np.random.default_rng(7)
    for _ in range(3):
        x0 = _lti_states(rng, b)
        np.testing.assert_array_equal(tsvc.solve(x0), jsvc.solve(x0))
    assert tsvc.stats.ticks == 3 and tsvc.stats.resets == 0


def test_mpc_service_device_linear_term(qqps):
    """The f32 device-side linear term is a sibling of the host path: the
    controls stay in the box and finite, and agree with the host route up
    to rounding ties."""
    _, port = qqps
    b = 32
    x0 = _lti_states(np.random.default_rng(8), b)
    dev = MPCService(port, batch=b, g_on_device=True).solve(x0)
    host = MPCService(port, batch=b, g_on_device=False).solve(x0)
    assert dev.shape == (b, 50) and np.isfinite(dev).all()
    assert np.abs(dev).max() <= 1.0 + 1e-12
    assert np.abs(dev - host).max() <= 2 * port.u_scale


def test_mpc_service_resets_bad_rows(qqps):
    _, port = qqps
    b = 4
    svc = MPCService(port, batch=b, g_on_device=False)
    x0 = _lti_states(np.random.default_rng(9), b)
    svc.solve(x0)
    x0[1, 0] = np.nan
    out = svc.solve(x0)
    assert svc.stats.resets == 1
    np.testing.assert_array_equal(out[1], 0.0)
    np.testing.assert_array_equal(unpack_controls(svc._warm)[1].numpy(), 0)
    with pytest.raises(ValueError, match="batch"):
        svc.solve(x0[:2])


def _rti_plan(u0, warm, unpack, n_dec, m):
    """Full lane plan of a tick: the returned first step plus the shifted
    warm plan."""
    rest = np.asarray(unpack(warm))[:, : n_dec - m]
    return np.concatenate([np.asarray(u0), rest], axis=-1)


def test_rti_service_cost_parity():
    ref = JDeviceSQP(**RTI_KW)
    port = device_sqp_config(ref)
    host = QuantizedSQP(**RTI_KW)
    b = 8
    jsvc, tsvc = JRTIService(ref, batch=b), RTIService(port, batch=b)
    rng = np.random.default_rng(10)
    x0 = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                   rng.uniform(0, 1, b)], axis=-1)
    jw, tw = jsvc._zero, tsvc._zero
    for _ in range(3):
        jw, ju0 = jsvc._tick(jw, jnp.asarray(x0, jnp.float32))
        tw, tu0 = tsvc._tick(tw, torch.as_tensor(x0, dtype=torch.float32))
        jplan = _rti_plan(ju0, jw, j_unpack, port.n_dec, port.n_ctrl)
        tplan = _rti_plan(tu0, tw, unpack_controls, port.n_dec, port.n_ctrl)
        np.testing.assert_allclose(
            host.true_cost(x0, tplan), host.true_cost(x0, jplan),
            rtol=0.01, atol=1e-4,
        )
    u = tsvc.solve(x0)
    assert u.shape == (b, 2) and np.isfinite(u).all()


def test_rti_service_resets_nonfinite_rows():
    port = device_sqp_config(JDeviceSQP(**RTI_KW))
    svc = RTIService(port, batch=3)
    x0 = np.array([[0.0, 0.0, 0.0], [np.inf, 0.0, 0.0], [0.1, 0.0, 0.5]])
    u = svc.solve(x0)
    assert svc.stats.resets == 1
    np.testing.assert_array_equal(u[1], 0.0)


def test_cuda_service_without_cuda_raises(qqps):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        MPCService(qqps[1], batch=4, device="cuda")


def test_port_imports_no_jax():
    code = ("import sys, pint_tpu_torch, pint_tpu_torch.convert, "
            "pint_tpu_torch.utils.timing, pint_tpu_torch.utils.profiling, "
            "pint_tpu_torch.ops.swar; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'pint_tpu' or m.startswith('pint_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=180)


def test_chip_smoke_refuses_without_cuda():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
