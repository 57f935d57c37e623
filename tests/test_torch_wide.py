"""Port parity past 256 lanes: the CPU route of the wide forms of K2, K2p
(``fused_pgd``, ``fused_pgd_packed``, ``FusedPGD``) and K7 (``alm_shared``,
``ConstrainedPGD``) against pint_tpu's at T = 260, the horizon of the wide
LTI path that chip_smoke.py drives on the card (Tp 260: a 128-lane tile and
a 64-byte k-chunk of padding past 256).

JAX's Pallas kernels run in interpret mode, as tests/test_fused.py and
tests/test_fused_alm.py run them.  Tolerance: bit-identical words and
multipliers.  The kernels themselves are held to these plain versions on
the card (tests/test_torch_kernels_cuda.py); here a CPU tensor takes the
plain version, and the wrappers' scratch plan is checked without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pint_tpu.models.dynamics import pack_controls as j_pack
from pint_tpu.mpc import condense_double_integrator as j_condense
from pint_tpu.mpc import constrain_states as j_constrain
from pint_tpu.mpc import quantize as j_quantize
from pint_tpu.mpc import quantize_constrained as j_quantize_c
from pint_tpu.mpc.fused import FusedPGD as JFused
from pint_tpu.mpc.fused_alm import alm_shared_fused_words as j_alm_shared
from pint_tpu_torch.convert import (
    quantized_constrained_qp_from_arrays,
    quantized_qp_from_arrays,
    words_from_numpy,
    words_to_numpy,
)
from pint_tpu_torch.models.dynamics import pack_controls
from pint_tpu_torch.mpc import FusedPGD, alm_shared

T, B, DT = 260, 9, 1.0 / 32.0


@pytest.fixture(scope="module")
def qqps():
    ref = j_quantize(j_condense(T=T), pad_to=4)
    port = quantized_qp_from_arrays(ref)
    assert port.padded == 260
    return ref, port


@pytest.fixture(scope="module")
def qcqps():
    qp = j_condense(T=T, dt=DT, q_pos=4.0)
    A = np.array([[1.0, DT], [0.0, 1.0]])
    Bm = np.array([[0.5 * DT * DT], [DT]])
    sc = j_constrain(qp, np.broadcast_to(A, (T, 2, 2)), np.broadcast_to(Bm, (T, 2, 1)),
                     None, F=[[0.0, 1.0]], lo=-0.25, hi=0.25)
    ref = j_quantize_c(sc, rho=50.0, pad_to=4)
    port = quantized_constrained_qp_from_arrays(ref)
    assert (port.qqp.padded, port.padded_rows) == (260, 260)
    return ref, port


@pytest.mark.parametrize("mode", ["lanes", "momentum", "packed_io"])
@pytest.mark.parametrize("iters", [0, 3])
def test_fused_pgd_at_tp260_bit_identical_to_jax(qqps, mode, iters):
    """FusedPGD(device="cpu") -- K2's plain version with momentum off and
    on, K2p's with packed_io -- equals JAX's FusedPGD at Tp 260 on warm
    words with -128 lanes."""
    ref, port = qqps
    rng = np.random.default_rng(iters)
    x0 = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], -1)
    g = ref.g_lane_fixed(x0)
    warm = rng.integers(-128, 128, (B, ref.padded), dtype=np.int32)
    u0 = np.asarray(j_pack(jnp.asarray(warm)))
    kw = dict(iters=iters, momentum=mode == "momentum", packed_io=mode == "packed_io")
    expect = np.asarray(JFused(ref, block_rows=8, interpret=True, **kw).solve_words(
        jnp.asarray(u0), jnp.asarray(g)))
    got = FusedPGD(port, device="cpu", **kw).solve_words(
        words_from_numpy(u0, device="cpu"), torch.from_numpy(g))
    np.testing.assert_array_equal(words_to_numpy(got), expect)


@pytest.mark.parametrize("outer, inners", [(2, 3), (2, 0), (0, 4)])
def test_alm_shared_at_260_bit_identical_to_jax(qcqps, outer, inners):
    """K7's CPU route (alm_shared on CPU tensors) equals JAX's kernel at Tp
    = Cp = 260 on warm lanes and multipliers, with and without inner
    iterations (the multiplier updates alone) and with no outer one."""
    ref, port = qcqps
    q, qq = ref, ref.qqp
    rng = np.random.default_rng(outer * 10 + inners)
    x0 = np.stack([rng.uniform(-1.5, 1.5, B), rng.uniform(-0.2, 0.2, B)], -1)
    g = qq.g_lane_fixed(x0)
    co = q.c_off_pre(x0)
    lanes = rng.integers(-128, 128, (B, qq.padded), dtype=np.int32)
    lam = rng.integers(-200, 400, (B, q.padded_rows), dtype=np.int32)
    rat = dict(hs_num=qq.hs_num, hs_den=qq.hs_den, cs_num=q.cs_num, cs_den=q.cs_den,
               eh_num=q.eh_num, eh_den=q.eh_den, el_num=q.el_num, el_den=q.el_den)
    kw = dict(outer=outer, inners=inners, g_shift=qq.g_shift, y_shift=q.y_shift)
    j_words = np.asarray(pack_controls(torch.as_tensor(lanes))).view(np.uint32)
    w_j, l_j = j_alm_shared(
        jnp.asarray(j_words), jnp.asarray(g), jnp.asarray(co), jnp.asarray(lam), Hq=qq.Hq,
        Sq=q.Sq, lo_pre=q.lo_pre, hi_pre=q.hi_pre, block_rows=8, interpret=True, **rat, **kw)
    t = torch.as_tensor
    out, lam_p = alm_shared(t(lanes), t(g), t(co), t(lam), t(qq.Hq), t(q.Sq),
                            t(q.lo_pre), t(q.hi_pre), **rat, **kw)
    np.testing.assert_array_equal(words_to_numpy(pack_controls(out)), np.asarray(w_j))
    np.testing.assert_array_equal(lam_p.numpy(), np.asarray(l_j))


@pytest.mark.parametrize("Tp, momentum", [(4, False), (256, True), (260, False),
                                          (260, True), (4096, True)])
def test_fused_pgd_scratch_only_past_256(Tp, momentum):
    """K2 and K2p's wrappers allocate the wide form's scratch past Tp 256
    alone, of the size the library gives for (B, Tp, momentum), on the
    operands' device; to 256 they pass none and ask the library nothing."""
    from pint_tpu_torch.mpc.fused import _scratch

    class Lib:
        def pint_fused_pgd_scratch(self, B, Tp, mom):
            return 1000 * B + Tp + 7 * mom

    got = _scratch(None if Tp <= 256 else Lib(), 3, Tp, momentum, torch.device("cpu"))
    if Tp <= 256:
        assert got is None
    else:
        assert got.dtype == torch.int8 and got.device.type == "cpu"
        assert got.shape == (3000 + Tp + 7 * momentum,)
