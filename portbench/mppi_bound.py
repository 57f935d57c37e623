"""The least time an H100 could take for a tick's MPPI updates, from the
cell's shapes (``mppi_roofline``).

The work is counted per candidate step, one of B U K T in a tick (B
plants, U updates, K candidates, T steps), as the fewest instructions a
kernel needs for the plain reference's map (:mod:`portbench.reference.
mppi`), each instruction on one lane's 32-bit values:

- int32 ALU, :data:`INT_ALU_PER_STEP` (22): the step's two saturating
  lane adds, an add and a min and a max each (6); the fixed-point map's
  sine and cosine, 11: each a mask of the half turn (``t & 0xFFFF &
  0x7FFF`` is one mask), a test of the half-turn bit (``((t >> 15) & 1)
  == 1`` is one test), the subtraction ``0x8000 - h``, the shift by 14
  and a negation predicated on the test (5, beside its product), and the
  cosine's quarter-turn add (1); x and y, a shift and an add each (4),
  since ``(((v << 8) >> 2) c >> 12) >> 5`` is ``(v c) >> 11`` exactly
  (|v c| <= 2**21, so no shift drops or wraps a bit); theta one
  shift-and-add (``lea``), since ``(w << 6) >> 5`` is ``w << 1``
  exactly.  The general shifts merge as those of :func:`merged_step`,
  which equals the plain map bit for bit;
- products, :data:`IMAD_PER_STEP` (4): the sine's and the cosine's, and
  v c and v s.  They issue on the FMA pipe, one issue each, which the f32
  rate counts as 2 operations;
- float32, :data:`F32_OPS_PER_STEP` (20): the score (``costs``, 16 a step:
  a state's x and y converted, scaled, less the goal and squared, 8, and
  summed, 1; the running sum, 1; a lane pair converted and squared, 4, and
  summed, 2) and the weighted mean (2 lanes, a multiply and an add each,
  4), operations as the f32 rate counts them (a fused multiply-add 2).
  A candidate's own work outside its steps (the score's 11 further
  operations at its ends, the weight) is left out, as are the sort and
  the noise draw, which runs outside the updates.

Bytes: the noise read (one byte a lane), the plans' words read and
written.  The least time is the largest of the three bounds: the int32
ALU and the FMA pipe issue side by side, so their times do not add.

Rates: :data:`portbench.costs.H100_SXM` (f32: 128 lanes an SM a clock, an
FMA counted 2), and for the int32 ALU a quarter of its f32 rate
(:data:`INT32_PER_S`): an H100 SM has 64 int32 lanes (16 in each of its
four partitions; NVIDIA's Hopper architecture paper), one operation a
clock each, where the data sheet's 67 TFLOP/s count 2 a clock on each of
128.  ``costs.py`` has no int32 rate; were the card's higher, the bound
would be lower, so ``mppi_roofline`` is an upper estimate.  Pure
arithmetic; nothing here is measured.
"""

from __future__ import annotations

from portbench import costs

INT_ALU_PER_STEP = {"add": 9, "lea": 1, "min_max": 4, "shift": 4, "logic": 4}
"""Instructions a candidate step by class: adds (the lane adds 2, the
sine's and cosine's subtraction and negation 4 and quarter turn 1, x and
y 2), theta's shift-and-add, the lane adds' clamps, the sine's and
cosine's shift and the x and y shifts, the masks and tests."""
INT_OPS_PER_STEP = sum(INT_ALU_PER_STEP.values())
IMAD_PER_STEP = 4
F32_OPS_PER_STEP = 16 + 4
INT32_PER_S = costs.H100_SXM["f32"] / 4


def merged_step(x, y, th, v, w, dt_shift: int, v_shift: int, w_shift: int):
    """The fixed-point map with its shifts merged as counted above, on
    integer tensors: equal to :func:`portbench.reference.mppi.q16_step`
    wherever ``|v| <= 128`` and ``|w| <= 128`` (a lane after the
    saturating add), for ``2 <= v_shift <= 14 + dt_shift`` and ``w_shift
    >= dt_shift``."""

    def sine(t):
        h = t & 0x7FFF
        val = (h * (0x8000 - h)) >> 14
        return (val ^ -((t >> 15) & 1)) + ((t >> 15) & 1)    # negated on the test

    xs = 12 + dt_shift - (v_shift - 2)
    ws = w_shift - dt_shift
    return (x + ((v * sine(th + (1 << 14))) >> xs), y + ((v * sine(th)) >> xs),
            th + (w << ws))


def update_bound_ms(B: int, U: int, K: int, T: int) -> float:
    """The least ms of U updates of K candidates of T steps on B plants."""
    steps = B * U * K * T
    nbytes = B * U * (K * 2 * T + 2 * 4 * (2 * T // 4))
    return 1e3 * max(steps * INT_OPS_PER_STEP / INT32_PER_S,
                     steps * (F32_OPS_PER_STEP + 2 * IMAD_PER_STEP) / costs.H100_SXM["f32"],
                     nbytes / costs.H100_SXM["bytes_per_s"])


def cell_bound_ms(cell) -> float:
    """:func:`update_bound_ms` at the cell's configuration and batch."""
    s = cell.config["solver"]
    return update_bound_ms(cell.traffic["batch"], s["updates_per_tick"], s["samples"],
                           s["horizon"])
