"""An SQP iteration's serial chain: the f32 rollout and linearization around
the lane plan, then the propagator recursion.

:func:`chain_plain` is the torch chain, a solver's
``DeviceSQP._linearize_phase`` then ``DeviceSQP._propagate_unrolled``, for
any model.  For a model with ``fused_chain`` (the
:class:`~pint_tpu_torch.models.dynamics.Unicycle`), :func:`chain_fused`
runs the whole chain in one CUDA kernel (``csrc/propagate.cu``) that writes
the same three stacks, bit for bit on the card for every problem whose
state is finite (the kernel writes +0.0 where a problem with a NaN state
has NaN in the columns no step has reached yet), and its plain version for
CPU tensors.  The solvers choose it at construction (``forms["chain"]``,
from :func:`chain_form`).

The kernel's launches are counted under "propagate" (:func:`launch_count`),
beside and not among :func:`~pint_tpu_torch.ops.kernels.launch_counts`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_tpu_torch.ops import kernels as K
from pint_tpu_torch.utils.profiling import span

__all__ = ["chain_form", "chain_fused", "chain_plain", "launch_count"]

Stacks = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def launch_count() -> int:
    """Launches of the chain's kernel since the last
    :func:`~pint_tpu_torch.ops.kernels.reset_launch_counts`, graph replays
    included."""
    return K._counts.get("propagate", 0)


def chain_form(model, recursion: bool) -> str:
    """The form of an SQP iteration's chain: "fused" (:func:`chain_fused`)
    where ``model`` has the chain kernel (its ``fused_chain``, as
    inherited) and the iteration runs the propagator recursion, else
    "torch" (:func:`chain_plain`)."""
    return "fused" if recursion and getattr(model, "fused_chain", False) else "torch"


def chain_plain(sqp, x0_f: torch.Tensor, lanes: torch.Tensor) -> Stacks:
    """Plain PyTorch version of :func:`chain_fused`, any model, any device:
    the solver ``sqp``'s ``_linearize_phase``, then its
    ``_propagate_unrolled``, each in its host range.  Returns (Abar (B, T,
    n, n), Bbar (B, T, n, Tm), Cbar (B, T, n))."""
    with span("pint.sqp.linearize"):
        A_seq, B_lane, c_seq = sqp._linearize_phase(x0_f, lanes)
    with span("pint.sqp.propagate"):
        return sqp._propagate_unrolled(A_seq, B_lane, c_seq)


def chain_fused(sqp, x0_f: torch.Tensor, lanes: torch.Tensor) -> Stacks:
    """The solver ``sqp``'s rollout, linearization and propagator recursion
    on the unicycle in one kernel launch, in the host range
    ``pint.sqp.propagate``: (Abar (B, T, 3, 3), Bbar (B, T, 3, 2T), Cbar
    (B, T, 3)) f32, contiguous, from ``lanes`` (B, 2T) int32 (any T: the
    width, not the solver's horizon, sets it) and ``x0_f`` (B, 3) f32, as
    :func:`chain_plain` returns them.  Kernel for CUDA tensors, plain
    version for CPU tensors."""
    model = sqp.model
    if chain_form(model, True) != "fused":
        raise ValueError(f"chain_fused: {type(model).__name__} has no chain kernel")
    if lanes.dim() != 2 or lanes.shape[1] % 2 or lanes.dtype != torch.int32:
        raise ValueError(f"lanes must be (B, 2T) int32, got {tuple(lanes.shape)} {lanes.dtype}")
    B, T = lanes.shape[0], lanes.shape[1] // 2
    if x0_f.shape != (B, 3) or x0_f.dtype != torch.float32:
        raise ValueError(f"x0_f must be ({B}, 3) float32, got {tuple(x0_f.shape)} {x0_f.dtype}")
    if x0_f.device.type == "cpu":
        return chain_plain(sqp, x0_f, lanes)
    sqp._check_dims(3)
    s = sqp._consts["s"]
    with span("pint.sqp.propagate"):
        lanes, x0_f = lanes.contiguous(), x0_f.contiguous()
        dev = K.require_cuda("chain_fused", lanes, x0_f, s)
        Abar = torch.empty((B, T, 3, 3), dtype=torch.float32, device=dev)
        Bbar = torch.empty((B, T, 3, 2 * T), dtype=torch.float32, device=dev)
        Cbar = torch.empty((B, T, 3), dtype=torch.float32, device=dev)
        if B == 0 or T == 0:
            return Abar, Bbar, Cbar
        with torch.cuda.device(dev):
            err = K.library().pint_propagate(
                lanes.data_ptr(), x0_f.data_ptr(), s.data_ptr(), Abar.data_ptr(),
                Bbar.data_ptr(), Cbar.data_ptr(), B, T, float(np.float32(model.dt)),
                K.stream_of(x0_f))
        K.check(err, "chain_fused")
        K.count_launch("propagate")
        return Abar, Bbar, Cbar
