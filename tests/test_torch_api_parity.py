"""The port's public surface against the reference's, name by name.

For every name in the ``__all__`` of ``pint_tpu`` and of its public
subpackages (a module's own ``__all__`` too), and for every public member
of their classes, the port must

* have the name;
* for every count k of positional arguments the reference accepts, bind the
  same k parameter names, or raise ``TypeError`` (so a positional call of the
  reference never quietly means another parameter in the port);
* take every parameter of the reference, leave optional what the reference
  leaves optional, and require nothing the reference does not.

The departures are written once, below, each with its reason (ROADMAP.md,
"Not in the port").
"""

import ast
import dataclasses
import functools
import importlib
import inspect
import textwrap
import types

import pytest

SUBPACKAGES = ("", ".mpc", ".models", ".parallel", ".utils", ".utils.checkpoint",
               ".ops", ".serving", ".native")

# TPU tile and interpret knobs: the CUDA kernels size their own blocks, and
# ``use_kernels`` / ``device`` take the place of ``interpret`` and ``devices``.
DROPPED = {
    "block_rows": "TPU knob: Pallas grid block of FusedPGD / ConstrainedPGD",
    "mxu_pack": "TPU knob: MXU block-diagonal packing of FusedPGD",
    "fused_block": "TPU knob: Pallas block of the fused inner",
    "lipq_block": "TPU knob: Pallas block of the power iteration",
    "interpret": "TPU knob: Pallas interpret mode; use_kernels takes its place",
    "devices": "JAX plumbing: a jax.Device list; the port runs one process a card",
}

# Members of the reference that the port does not have.
MISSING = {
    "pint_tpu.PackedArray.tree_flatten": "JAX plumbing: pytree registration",
    "pint_tpu.PackedArray.tree_unflatten": "JAX plumbing: pytree registration",
}

# Parameters the port names differently: reference name -> port name.
_GEN = {"key": "gen"}   # explicit torch generators for JAX's PRNG keys
RENAMED = {
    "pint_tpu.mpc.QuantizedMPPI.plan": _GEN,
    "pint_tpu.mpc.QuantizedMPPI.step": _GEN,
    "pint_tpu.mpc.QuantizedMPPI.run_closed_loop": _GEN,
    # a NamedSharding becomes the mesh and the spec it was made of
    "pint_tpu.utils.checkpoint.load_sharded": {"sharding": "mesh"},
}

# Parameters the port requires that the reference does not have.
ADDED = {"pint_tpu.utils.checkpoint.load_sharded": {"spec"}}

_P = inspect.Parameter
_POSITIONAL = (_P.POSITIONAL_ONLY, _P.POSITIONAL_OR_KEYWORD)
_ABSENT = object()


def _surface():
    """``{dotted name: (reference object, port object or _ABSENT)}``."""
    out = {}
    for sub in SUBPACKAGES:
        ref = importlib.import_module("pint_tpu" + sub)
        port = importlib.import_module("pint_tpu_torch" + sub)
        for name in ref.__all__:
            r, p = getattr(ref, name), getattr(port, name, _ABSENT)
            out[f"pint_tpu{sub}.{name}"] = (r, p)
            if isinstance(r, types.ModuleType):
                for inner in r.__all__:
                    out[f"pint_tpu{sub}.{name}.{inner}"] = (
                        getattr(r, inner), getattr(p, inner, _ABSENT))
            elif inspect.isclass(r):
                # a dataclass field is a constructor parameter, checked there
                fields = ({f.name for f in dataclasses.fields(r)}
                          if dataclasses.is_dataclass(r) else set())
                for member in dir(r):
                    if member.startswith("_") or member in fields:
                        continue
                    mine = getattr(p, member, _ABSENT)
                    if (mine is _ABSENT and isinstance(getattr(r, member), (property, functools.cached_property))
                            and _set_in_init(p, member)):
                        mine = "an attribute set in __init__"
                    out[f"pint_tpu{sub}.{name}.{member}"] = (getattr(r, member), mine)
    return out


def _set_in_init(cls, member):
    """Whether ``cls.__init__`` assigns ``self.<member>``: the port may keep
    as an attribute what the reference computes in a (cached) property."""
    init = vars(cls).get("__init__")
    if init is None:
        return False
    tree = ast.parse(textwrap.dedent(inspect.getsource(init)))
    return any(isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
               and n.attr == member and getattr(n.value, "id", None) == "self"
               for n in ast.walk(tree))


SURFACE = _surface()


def _signature(obj):
    if not callable(obj):
        return None
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):   # a builtin without one
        return None


CALLABLES = sorted(n for n, (r, _) in SURFACE.items()
                   if _signature(r) is not None and n not in MISSING)


def _pair(name):
    r, p = SURFACE[name]
    assert p is not _ABSENT, f"the port has no {name}"
    rs, ps = _signature(r), _signature(p)
    assert ps is not None, f"the port's {name} has no signature"
    return rs, ps


def _bound(sig, k):
    """The parameter names ``k`` positional arguments bind to (a ``*args``
    parameter once for each argument it takes), or None on ``TypeError``."""
    try:
        bound = sig.bind_partial(*range(k))
    except TypeError:
        return None
    names = []
    for name, value in bound.arguments.items():
        star = sig.parameters[name].kind == _P.VAR_POSITIONAL
        names += [name] * len(value) if star else [name]
    return names


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_port_has_the_name(name):
    if name in MISSING:
        assert SURFACE[name][1] is _ABSENT, f"{name} is listed as missing"
    else:
        assert SURFACE[name][1] is not _ABSENT, f"the port has no {name}"


@pytest.mark.parametrize("name", CALLABLES)
def test_positional_calls_bind_the_same_names(name):
    rs, ps = _pair(name)
    rename = RENAMED.get(name, {})
    most = sum(q.kind in _POSITIONAL for q in rs.parameters.values())
    if any(q.kind == _P.VAR_POSITIONAL for q in rs.parameters.values()):
        most += 3
    for k in range(most + 1):
        want = _bound(rs, k)
        if want is None:
            continue      # the reference refuses k positional arguments
        got = _bound(ps, k)
        if got is None:
            continue      # so does the port: the call fails loudly
        assert got == [rename.get(n, n) for n in want], (
            f"{name} with {k} positional arguments binds {got} in the port, "
            f"{want} in the reference")


@pytest.mark.parametrize("name", CALLABLES)
def test_parameters_keep_their_defaults(name):
    rs, ps = _pair(name)
    rename = RENAMED.get(name, {})
    port_kwargs = any(q.kind == _P.VAR_KEYWORD for q in ps.parameters.values())
    required = set()
    for q in rs.parameters.values():
        if q.kind in (_P.VAR_POSITIONAL, _P.VAR_KEYWORD):
            continue
        mine = ps.parameters.get(rename.get(q.name, q.name))
        if mine is None:
            assert q.name in DROPPED or port_kwargs, (
                f"{name}: the port takes no {q.name!r}")
            continue
        if q.default is _P.empty:
            required.add(mine.name)
        else:
            assert mine.default is not _P.empty, (
                f"{name}: {q.name!r} is optional in the reference, required in the port")
    extra = {q.name for q in ps.parameters.values()
             if q.default is _P.empty and q.kind not in (_P.VAR_POSITIONAL, _P.VAR_KEYWORD)}
    extra -= required | ADDED.get(name, set())
    assert not extra, f"{name}: the port requires {sorted(extra)}, the reference does not"


def test_every_departure_is_one():
    """Each entry of the allow-lists names a real departure, so none outlives
    the difference it was written for."""
    for name in MISSING:
        assert name in SURFACE and SURFACE[name][1] is _ABSENT, name
    params = {n: _pair(n) for n in CALLABLES}
    used = {q.name for rs, ps in params.values() for q in rs.parameters.values()
            if q.name not in ps.parameters}
    assert set(DROPPED) <= used, sorted(set(DROPPED) - used)
    for name, rename in RENAMED.items():
        rs, ps = params[name]
        for old, new in rename.items():
            assert old in rs.parameters and old not in ps.parameters, (name, old)
            assert new in ps.parameters and new not in rs.parameters, (name, new)
    for name, added in ADDED.items():
        rs, ps = params[name]
        for extra in added:
            assert extra not in rs.parameters and ps.parameters[extra].default is _P.empty


def test_the_surface_is_whole():
    """The walk reaches every subpackage, its classes' members and the
    constructors this file was written to hold."""
    for name in ("pint_tpu.mpc.FusedPGD", "pint_tpu.mpc.DeviceSQP",
                 "pint_tpu.mpc.DeviceConstrainedSQP", "pint_tpu.mpc.ConstrainedPGD",
                 "pint_tpu.parallel.make_mesh", "pint_tpu.parallel.host_local_mesh",
                 "pint_tpu.PackedArray.pack", "pint_tpu.PackedArray.from_words",
                 "pint_tpu.ops.word.add_wrap", "pint_tpu.native.NativeOps.pack"):
        assert name in CALLABLES, name
    assert len(SURFACE) > 250
