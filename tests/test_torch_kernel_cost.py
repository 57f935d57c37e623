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
    ("propagate", dict(B=4096, T=16, n=6, m=2), 61.96, 0.11325, 0.018497, "bytes"),
    ("propagate", dict(B=4096, T=32, n=3, m=2), 108.05, 0.0873, 0.03225, "bytes"),
    ("reduce", dict(B=4096, T=32, n=3, m=2), 126.4, 1.6072, 0.03773, "bytes"),
    ("reduce", dict(B=16384, T=32, n=3, m=2), 505.6, 6.4288, 0.1509, "bytes"),
    ("reduce", dict(B=4096, T=128, n=3, m=2), 1914.7, 77.094, 1.1507, "operations"),
    ("stack", dict(B=4096, T=32, n=3, Tm=64, Cs=1), 142.61, 0.08913, 0.04257, "bytes"),
    ("stack", dict(B=16384, T=32, n=3, Tm=64, Cs=1), 570.43, 0.35652, 0.17028, "bytes"),
    ("stack", dict(B=4096, T=128, n=3, Tm=256, Cs=1), 2181.0, 1.3631, 0.65106, "bytes"),
    ("stack", dict(B=4096, T=16, n=6, Tm=32, Cs=1), 71.565, 0.05623, 0.021363, "bytes"),
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


@pytest.mark.parametrize("n, m", [(3, 2), (6, 2), (2, 1)])
def test_propagate_counts_the_stacks_it_writes(n, m):
    """Abar (T, n, n), Bbar (T, n, Tm) and Cbar (T, n) written and the lanes
    (Tm) and x0 (n) read, 4 bytes a value; 2 n^2 operations a column a step
    over S_k's live columns and P_k's and c_k's n + 1; the unicycle's
    shape without n and m."""
    B, T = 7, 5
    Tm = T * m
    cost = kernel_cost("propagate", B=B, T=T, n=n, m=m)
    assert cost.bytes == 4 * B * (T * n * n + T * n * Tm + T * n + Tm + n)
    assert cost.ops == B * sum(2 * n * n * ((k + 1) * m + n + 1) for k in range(T))
    assert cost.op_type == "f32"
    if (n, m) == (3, 2):
        assert kernel_cost("propagate", B=B, T=T) == cost


def test_reduce_counts_the_live_triangle():
    """Ht[j1, j2] for j1 <= j2 sums the steps t >= max(j1, j2) // m, 2n
    roundings each (n products, n - 1 sums, the accumulation), counted here
    pair by pair; W, g and the terminal term on top; each f32 rounding two
    of the peak's operations (no FMA)."""
    B, T, n, m = 7, 5, 3, 2
    Tm = T * m
    pairs = sum(T - max(j1, j2) // m for j2 in range(Tm) for j1 in range(j2 + 1))
    live = sum(n * min((t + 1) * m, Tm) for t in range(T))
    rounds = (2 * n * pairs + (2 * n - 1) * live + 2 * (n + 1) * live
              + (2 * n + 1) * Tm * (Tm + 1) // 2)
    cost = kernel_cost("reduce", B=B, T=T, n=n, m=m)
    assert cost.ops == 2 * rounds * B and cost.op_type == "f32"
    assert cost.bytes == 4 * B * (live + T * n * (n + 1) + n + Tm * Tm + Tm)


@pytest.mark.parametrize("B, T, n, Tm, Cs", [(4096, 32, 3, 64, 1), (16384, 32, 3, 64, 1),
                                             (4096, 128, 3, 256, 1), (4096, 16, 6, 32, 1),
                                             (7, 5, 3, 12, 3)])
def test_stack_counts_every_column(B, T, n, Tm, Cs):
    """The four constrained cells' shapes (crti_t32 at both fleets,
    crti_t128, cquad_t16) and three rows a step: Bbar (T, n, Tm), Abar
    (T, n, n) and Cbar (T, n) read, the dead columns too; S_t (T Cs, Tm),
    P_t (T Cs, n) and r_t (T Cs) written; 4 bytes a value.  Each output a
    dot over n: n products and n - 1 sums, each rounding two of the f32
    peak's operations (no FMA)."""
    cost = kernel_cost("stack", B=B, T=T, n=n, Tm=Tm, Cs=Cs)
    read = T * n * Tm + T * n * n + T * n
    written = T * Cs * Tm + T * Cs * n + T * Cs
    assert cost.bytes == 4 * B * (read + written)
    assert cost.ops == 2 * (2 * n - 1) * written * B and cost.op_type == "f32"
    assert bound_ms(cost)[1] == "bytes"


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
