"""The least time an H100 could take for an SQP iteration's serial chain
(the f32 rollout, its linearization and the propagator recursion,
``pint_tpu_torch/csrc/propagate.cu``), from the cell's shapes.

A frozen copy of the port's arithmetic for that kernel
(``utils.profiling.kernel_cost("propagate")``), beside
:mod:`portbench.costs`, which holds K3-K6's and is not edited: the stacks
written, Abar (n, n), Bbar (n, Tm) and Cbar (n) a step, and the int32 plan
and the state read, 4 bytes a value; the recursion's products and sums, 2
n^2 a column a step (n rows of n, summed from +0.0) over the live columns
of S_k (m (k + 1) at step k) and the n + 1 of P_k and c_k, the scalar
rollout left out; against :data:`portbench.costs.H100_SXM`.  Pure
arithmetic; nothing here is measured.
"""

from __future__ import annotations

from portbench import costs


def chain_cost(B: int, T: int, n: int, m: int) -> costs.KernelCost:
    """Bytes and f32 operations of one chain launch on B problems."""
    Tm = m * T
    return costs.KernelCost(
        B * (4 * (n * n * T + n * T * Tm + n * T) + 4 * Tm + 4 * n),
        2 * n * n * (m * T * (T + 1) // 2 + (n + 1) * T) * B, "f32")


def cell_bound_ms(cell) -> float:
    """The least ms of a tick's chain launches in ``cell``: one an SQP
    iteration, at the configuration's horizon, state and control widths
    (the lengths of ``Q_diag`` and ``R_diag``) and the traffic's batch."""
    s = cell.config["solver"]
    cost = chain_cost(cell.traffic["batch"], s["horizon"], len(s["Q_diag"]),
                      len(s["R_diag"]))
    return s["sqp_iters"] * costs.bound_ms(cost)[0]
