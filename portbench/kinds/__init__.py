"""What the runner needs of each kind of service, one module a kind.

A configuration's file names its ``kind``; the module of that name here
says how to build the port's public entry from the configuration, which
solver call the window's ticks go through (the runner times ``solve``,
wraps ``solve_words`` for its spans and records its warm state for the
check), which kernels a tick should launch, the kernels' work at the cell's
shapes, and the plain reference that re-solves a tick.  A module gives:

- ``build(config, batch, device)``: the service, ``service.solve(states)``
  the public call the window times;
- ``solver(service)``: the object whose ``solve_words`` the tick calls;
- ``RECORD_IN``: the warm state the check records, as names of
  ``solve_words``'s parameters, and ``record_out(result)`` the answer;
- ``LAUNCHES``: the port's kernel entries a tick should call
  (``kernels_roofline`` reads nothing in a slice that calls others);
- ``work(config, batch)``: (kernel, shape) of the tick's inner work, for
  :mod:`portbench.costs`;
- ``Reference(config, device)``: the reference (``zeros``, ``step``,
  ``shift``, ``lanes``, ``m``, ``lane_scales``).
"""
