"""One module a plant, named by the configuration's ``model.name``.

``<name>.py`` defines ``Plant(model)``, built from the configuration's
``model`` group, with ``box``, the largest magnitude of each control
component the service may return (the int8 box in physical units), and
``step(x, u)``: the states (batch, n) float64 one step on under the
finite physical controls u the service returned.  :mod:`portbench.fleet`
adds the traffic's disturbance, redraws and faults around it.
"""
