"""The traffic of a control service: a fleet of plants served tick by tick.

A client sends every plant's state, waits for the controls, applies them,
and sends the new states at the next tick.  A traffic mix is a data file
(``traffic/<mix>.json``) that this one generator reads:

- ``loop``: the module under ``portbench/loops/`` that says when each
  tick of the window is due (``closed``: as soon as the last is done);
- ``batch``: plants in the fleet, one row of every request;
- ``process_noise_std``: per state component, the standard deviation of
  the Gaussian disturbance added at each plant step;
- ``redraw_share``: the share of plants replaced by new tasks after each
  tick, drawn again from the configuration's initial-state box;
- ``fault_share`` (optional, 0 by default): the share of plants whose
  state is sent as not a number at the next tick, as a sensor that
  dropped out; the plant itself goes on under the control it gets back.

The redraws and the faults take the same number of plants every tick, so
every seed does the same work.  The configuration gives the plant
(``model.name`` names the module under ``portbench/plants/``) and the box
the initial states are drawn from (``initial_states``: ``low`` and
``high`` per component).  Everything random comes from one ``numpy``
generator seeded by ``--seed``.
"""

from __future__ import annotations

import importlib

import numpy as np

SEED_MASK = (1 << 64) - 1


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and a sub-stream number, so
    that the fleet and the sampling of the check draw independently."""
    return np.random.default_rng([seed & SEED_MASK, stream])


class Fleet:
    """``batch`` plants, their states, and their step under the controls
    the service returns."""

    def __init__(self, traffic: dict, config: dict, seed: int):
        self.batch = int(traffic["batch"])
        self.noise = np.asarray(traffic["process_noise_std"], np.float64)
        self.redraw = int(round(float(traffic["redraw_share"]) * self.batch))
        self.faults = int(round(float(traffic.get("fault_share", 0.0)) * self.batch))
        box = config["initial_states"]
        self.low = np.asarray(box["low"], np.float64)
        self.high = np.asarray(box["high"], np.float64)
        model = config["model"]
        self.plant = importlib.import_module(f"portbench.plants.{model['name']}").Plant(model)
        self.rng = rng_of(seed)
        self.x = self._draw(self.batch)

    def _draw(self, n: int) -> np.ndarray:
        return self.rng.uniform(self.low, self.high, (n, self.low.size))

    def step(self, u: np.ndarray) -> np.ndarray:
        """Apply the controls u (batch, m) physical for one step; a control
        that is not finite acts as zero.  Then the disturbance, then the
        redraw.  Returns the states sent at the next tick, the faults'
        rows not a number."""
        u = np.where(np.isfinite(u), u, 0.0)
        nxt = self.plant.step(self.x, u)
        nxt += self.rng.standard_normal(nxt.shape) * self.noise
        if self.redraw:
            rows = self.rng.choice(self.batch, self.redraw, replace=False)
            nxt[rows] = self._draw(self.redraw)
        self.x = nxt
        if not self.faults:
            return nxt
        sent = nxt.copy()
        sent[self.rng.choice(self.batch, self.faults, replace=False)] = np.nan
        return sent
