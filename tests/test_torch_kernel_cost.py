"""Bytes, operations and bounds of the MPC kernels from their shapes
(``pint_tpu_torch.utils.profiling.kernel_cost`` / ``bound_ms``): the
main-path shapes against figures worked out by hand from the code and the
H100's published 3.35 TB/s, 1,979 int8 TOP/s and 67 f32 TFLOP/s."""

import pytest

from pint_tpu_torch.layout import PackedLayout
from pint_tpu_torch.utils.profiling import H100_SXM, bound_ms, kernel_cost

MB = 1e6

# kernel, shape, (bytes in MB, rel tol), G operations, bound ms, bound by
MAIN_PATH = [
    ("fused_pgd", dict(B=8192, Tp=64, iters=15), 6.3, 1.007, 0.0019, "bytes"),
    ("fused_pgd", dict(B=8192, Tp=64, iters=15, packed=True), 3.15, 1.007, 0.00094,
     "bytes"),
    ("lipq", dict(B=4096, Tm=64, power_iters=16), 67.1 + 16.8, 0.570, 0.0251, "bytes"),
    ("pgd_hqt", dict(B=4096, Tp=64, iters=30), 16.8 + 3.1, 1.007, 0.0060, "bytes"),
    ("pgd_hqt", dict(B=4096, Tp=64, iters=30, words=True), 16.8 + 1.6, 1.007, 0.0055,
     "bytes"),
    ("propagate", dict(B=4096, T=32), 108.05, 0.0873, 0.03225, "bytes"),
    ("propagate", dict(B=16384, T=32), 432.2, 0.349, 0.1290, "bytes"),
    ("propagate", dict(B=4096, T=128), 1640.0, 1.2552, 0.4896, "bytes"),
]


@pytest.mark.parametrize("kernel, shape, mb, gops, ms, by", MAIN_PATH,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_main_path_bounds(kernel, shape, mb, gops, ms, by):
    cost = kernel_cost(kernel, **shape)
    assert cost.bytes / MB == pytest.approx(mb, rel=0.01)
    assert cost.ops / 1e9 == pytest.approx(gops, rel=0.01)
    got_ms, got_by = bound_ms(cost)
    assert got_ms == pytest.approx(ms, rel=0.02)
    assert got_by == by


def test_k3_counts_exactly():
    """Ht f32 in, hqt int8 out, lip and h_max f32 out; a multiply and an
    add per MAC over 17 power steps."""
    B, Tm = 4096, 64
    cost = kernel_cost("lipq", B=B, Tm=Tm, power_iters=16)
    assert cost.bytes == 4 * Tm * Tm * B + Tm * Tm * B + 8 * B
    assert cost.ops == 17 * 2 * Tm * Tm * B
    assert cost.op_type == "f32"


def test_k4_words_entry_moves_a_quarter_of_the_lanes():
    lanes = kernel_cost("pgd_hqt", B=4096, Tp=64, iters=30)
    words = kernel_cost("pgd_hqt", B=4096, Tp=64, iters=30, words=True)
    assert lanes.bytes - words.bytes == 2 * 4096 * 64 * 3
    assert lanes.ops == words.ops


def test_alm_counts_one_orientation_of_the_constraint_rows():
    """K5 takes Sq in two orientations (sqj, sqc) but needs one: its bytes
    are hqt, one Sq, the lanes and int32 vectors, read or written once."""
    B, Tp, Cp = 4096, 64, 64
    cost = kernel_cost("alm", B=B, Tp=Tp, Cp=Cp, outer=3, inners=30)
    assert cost.bytes == (B * (Tp * Tp + Cp * Tp) + 4 * B * (2 * Cp + 8)
                          + 4 * B * (2 * Tp + 4 * Cp))
    assert bound_ms(cost)[1] == "bytes"


def test_operations_bound_a_long_shared_alm():
    """K7 at the LTI constrained shape does 97 G int8 operations on 6.3 MB:
    the tensor-core peak, not memory, sets its bound."""
    cost = kernel_cost("alm_shared", B=4096, Tp=64, Cp=64, outer=12, inners=60)
    ms, by = bound_ms(cost)
    assert by == "operations"
    assert ms == pytest.approx(cost.ops / H100_SXM["int8"] * 1e3)


def test_swar_headline_is_memory_bound():
    """K1 on 16Mi u32 words moves 201 MB: 0.060 ms at 3.35 TB/s."""
    lay = PackedLayout(8, 8, 8, 8)
    cost = kernel_cost("swar", layout=lay, kind="binop", n=1 << 24,
                       op="add_unsigned_saturate")
    assert cost.bytes == 3 * 4 * (1 << 24)
    ms, by = bound_ms(cost)
    assert by == "bytes" and ms == pytest.approx(0.0601, rel=0.01)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError):
        kernel_cost("no_such_kernel", B=1)
