"""Each kernel entry's share of its roofline (``portbench/layers/
lipq_roofline.py``, ``pen_roofline.py``, ``alm_roofline.py``) and the
helper they read the sources with (``portbench/entries.py``), on
hand-built ``trace.Summary`` slices: the share is the bound of the kind's
work for that entry over the device ms a tick of the kernels its file
declares, and nothing is read where the slice cannot tell that time apart.
This file imports neither jax nor pint_tpu."""

import re
import types
from pathlib import Path

import pytest

from portbench import costs, entries, run, trace

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pint_tpu_torch" / "csrc"
ENTRIES = ("lipq", "pen", "alm")
TICKS = [(0, 10_000), (20_000, 30_000)]

# the names as the profiler gives them, one (start, end) a tick of each
KERNELS = {
    "crti_t128-fleet4096": {
        "lipq": ("void lipq_long_kernel<64>(float const*, signed char*, float*, float*)",
                 (100, 1655)),
        "pen": ("void (anonymous namespace)::pen_wide_kernel(PenArgs)", (2000, 4527)),
        "alm": ("void (anonymous namespace)::alm_wide_kernel<signed char, 4>(WideArgs<signed "
                "char>)", (5000, 9060)),
    },
    "crti_t32-fleet16384": {
        "lipq": ("void lipq_reg_kernel<1>(CUtensorMap_st, signed char*, float*, float*, int)",
                 (100, 434)),
        "pen": ("void (anonymous namespace)::pen_reg_kernel(CUtensorMap_st, PenArgs)",
                (500, 793)),
        "alm": ("void (anonymous namespace)::alm_reg_kernel<2>(int const*, int const*)",
                (900, 1786)),
    },
}


def _slice(cell, calls, drop=()):
    """Two ticks of the cell's kernels (those of ``drop`` left out), a
    torch operation beside them, the kernel entries ``calls`` a tick."""
    ops = []
    for a, _ in TICKS:
        ops.append(trace.DeviceOp("void at::native::elementwise_kernel<128, 2>()", a, a + 90,
                                  "solver", False))
        for entry, (name, (s, e)) in KERNELS[cell].items():
            if entry not in drop:
                ops.append(trace.DeviceOp(name, a + s, a + e, "solver", True))
    return trace.Summary(TICKS, 0, TICKS[-1][1], ops, [], 0, 0, calls=dict(calls))


def _bound_ms(cell, entry):
    shape = dict(cell.kind.work(cell.config, cell.traffic["batch"]))[entry]
    return costs.bound_ms(costs.kernel_cost(entry, **shape))[0]


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("workload", list(KERNELS))
def test_the_share_is_the_bound_over_the_entrys_device_ms(workload, entry):
    cell = run.load_cell(ROOT, workload)
    got = run.reader(ROOT, f"{entry}_roofline")(_slice(workload, cell.kind.LAUNCHES), cell)
    s, e = KERNELS[workload][entry][1]
    assert got == pytest.approx(100.0 * _bound_ms(cell, entry) / ((e - s) / 1e6))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("calls", [
    {"lipq": 1.0, "pen": 1.0},                          # K5's work ran elsewhere
    {"lipq": 1.0, "pen": 1.0, "alm": 2.0},              # twice the work a tick
    {},
])
def test_nothing_is_read_unless_the_entries_called_are_the_kinds(entry, calls):
    cell = run.load_cell(ROOT, "crti_t128-fleet4096")
    assert run.reader(ROOT, f"{entry}_roofline")(_slice("crti_t128-fleet4096", calls),
                                                 cell) is None


def _kind(launches):
    """A kind whose tick calls ``launches``, with the crti kind's work and a
    K4 at the same lanes."""
    crti = run.load_cell(ROOT, "crti_t128-fleet4096").kind

    def work(config, batch):
        return crti.work(config, batch) + [
            ("pgd_hqt", dict(B=batch, Tp=256, iters=30, words=True))]

    return types.SimpleNamespace(LAUNCHES=launches, work=work)


def test_nothing_is_read_where_another_called_entry_shares_the_file():
    """K4 past 64 lanes runs ``alm.cu``'s cluster kernel (``pint_pgd_wide``):
    where a tick calls both, ``alm.cu``'s kernel time is not K5's alone."""
    cell = run.load_cell(ROOT, "crti_t128-fleet4096")
    launches = {"lipq": 1, "pen": 1, "alm": 1, "pgd_hqt": 1}
    cell.kind = _kind(launches)
    summary = _slice("crti_t128-fleet4096", launches)
    assert run.reader(ROOT, "alm_roofline")(summary, cell) is None
    for entry in ("lipq", "pen"):              # their files are their own
        s, e = KERNELS["crti_t128-fleet4096"][entry][1]
        assert run.reader(ROOT, f"{entry}_roofline")(summary, cell) == pytest.approx(
            100.0 * _bound_ms(cell, entry) / ((e - s) / 1e6))


@pytest.mark.parametrize("entry", ENTRIES)
def test_nothing_is_read_beside_an_entry_not_in_the_sources(entry):
    cell = run.load_cell(ROOT, "crti_t128-fleet4096")
    launches = {"lipq": 1, "pen": 1, "alm": 1, "no_such_entry": 1}
    cell.kind = _kind(launches)
    assert run.reader(ROOT, f"{entry}_roofline")(
        _slice("crti_t128-fleet4096", launches), cell) is None


@pytest.mark.parametrize("entry", ENTRIES)
def test_nothing_is_read_where_none_of_the_entrys_kernels_ran(entry):
    cell = run.load_cell(ROOT, "crti_t128-fleet4096")
    summary = _slice("crti_t128-fleet4096", cell.kind.LAUNCHES, drop=(entry,))
    assert run.reader(ROOT, f"{entry}_roofline")(summary, cell) is None


@pytest.mark.parametrize("source", ["lipq.cu", "pen.cu", "alm.cu"])
def test_every_kernel_of_the_sources_is_mapped_to_its_file(source):
    mapped = entries.kernel_files(CSRC)
    assert set(mapped) == set(trace.port_kernels(CSRC))
    mine = {k for k, f in mapped.items() if f == source}
    text = (CSRC / source).read_text()
    assert len(mine) == len(re.findall(r"__global__\s+void", text))
    assert all(re.search(rf"\b{k}\b", text) for k in mine)


@pytest.mark.parametrize("entry, files", [
    ("lipq", {"lipq.cu"}),
    ("pen", {"pen.cu"}),
    ("alm", {"alm.cu"}),
    ("alm_shared", {"alm.cu"}),
    ("pgd_hqt", {"pgd_hqt.cu", "alm.cu"}),        # past 64 lanes, pint_pgd_wide
    ("fused_pgd_packed", {"fused_pgd.cu"}),
    ("swar_binop_pair", {"swar.cu"}),
    ("no_such_entry", None),
])
def test_an_entry_runs_the_kernels_of_the_files_it_calls_into(entry, files):
    assert entries.files(entry, CSRC) == (None if files is None else frozenset(files))


# -- propagate_device_ms: the chain kernel's device ms a tick --------------------

CHAIN = "void (anonymous namespace)::propagate_kernel<4>(int2 const*, float const*, float const*, float*, float*, float*, int, int, int, float)"


def _chain_slice(where="solver", port=True, name=CHAIN):
    """Two ticks, each with the chain kernel twice (100 + 50 ns, overlapping
    by 10) and a torch operation beside it."""
    ops = []
    for a, _ in TICKS:
        ops.append(trace.DeviceOp("void at::native::elementwise_kernel<128, 2>()", a, a + 90,
                                  "solver", False))
        ops.append(trace.DeviceOp(name, a + 100, a + 200, where, port))
        ops.append(trace.DeviceOp(name, a + 190, a + 240, where, port))
    return trace.Summary(TICKS, 0, TICKS[-1][1], ops, [], 0, 0)


@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t128-fleet4096"])
def test_propagate_device_ms_is_the_chain_kernels_union_a_tick(workload):
    cell = run.load_cell(ROOT, workload)
    assert "propagate_device_ms" in {m["name"] for m in cell.per_layer}
    got = run.reader(ROOT, "propagate_device_ms")(_chain_slice(), cell)
    assert got == pytest.approx(140 / 1e6)


@pytest.mark.parametrize("kw", [dict(where="serve"), dict(port=False),
                                dict(name="void lipq_reg_kernel<1>(CUtensorMap_st)")],
                         ids=["outside-the-solver", "not-the-ports", "another-kernel"])
def test_propagate_device_ms_reads_nothing_without_the_chain_kernel(kw):
    cell = run.load_cell(ROOT, "crti_t32-fleet16384")
    assert run.reader(ROOT, "propagate_device_ms")(_chain_slice(**kw), cell) is None


def test_propagate_device_ms_reads_nothing_for_a_program_without_the_file(monkeypatch,
                                                                          tmp_path):
    """A program with no ``csrc/propagate.cu``, as the parent of the kernel
    is, reads None rather than raising."""
    for p in CSRC.glob("*.cu"):
        if p.name != "propagate.cu":
            (tmp_path / p.name).write_text(p.read_text())
    monkeypatch.setattr(entries, "csrc", lambda: tmp_path)
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    assert run.reader(ROOT, "propagate_device_ms")(_chain_slice(), cell) is None


# -- reduce_device_ms: the reduce kernel's device ms a tick ----------------------

REDUCE = "void (anonymous namespace)::reduce_kernel<3, 8>((anonymous namespace)::Args)"


@pytest.mark.parametrize("workload", ["rti_t32-fleet4096", "crti_t32-fleet4096",
                                      "rti_t32-fleet16384", "crti_t32-fleet16384",
                                      "crti_t128-fleet4096"])
def test_reduce_device_ms_is_the_reduce_kernels_union_a_tick(workload):
    cell = run.load_cell(ROOT, workload)
    assert "reduce_device_ms" in {m["name"] for m in cell.per_layer}
    got = run.reader(ROOT, "reduce_device_ms")(_chain_slice(name=REDUCE), cell)
    assert got == pytest.approx(140 / 1e6)


@pytest.mark.parametrize("kw", [dict(where="serve"), dict(port=False), dict(name=CHAIN)],
                         ids=["outside-the-solver", "not-the-ports", "the-chain-kernel"])
def test_reduce_device_ms_reads_nothing_without_the_reduce_kernel(kw):
    cell = run.load_cell(ROOT, "crti_t32-fleet16384")
    assert run.reader(ROOT, "reduce_device_ms")(_chain_slice(**dict(dict(name=REDUCE), **kw)),
                                                cell) is None


def test_reduce_device_ms_reads_nothing_for_a_program_without_the_file(monkeypatch, tmp_path):
    """A program with no ``csrc/reduce.cu``, as the parent of the kernel is,
    reads None rather than raising."""
    for p in CSRC.glob("*.cu"):
        if p.name != "reduce.cu":
            (tmp_path / p.name).write_text(p.read_text())
    monkeypatch.setattr(entries, "csrc", lambda: tmp_path)
    cell = run.load_cell(ROOT, "rti_t32-fleet4096")
    assert run.reader(ROOT, "reduce_device_ms")(_chain_slice(name=REDUCE), cell) is None


# -- mppi_kernel_share: the updates that ran as the update's kernel -------------------

MPPI = "void (anonymous namespace)::mppi_update_kernel<512>((anonymous namespace)::Args)"


def _mppi_slice(per_tick=2, where="solver", port=True, name=MPPI):
    """Two ticks, each with ``per_tick`` launches of ``name`` and a torch
    operation beside them."""
    ops = []
    for a, _ in TICKS:
        ops.append(trace.DeviceOp("void at::native::elementwise_kernel<128, 2>()", a, a + 90,
                                  "solver", False))
        for i in range(per_tick):
            ops.append(trace.DeviceOp(name, a + 100 + 300 * i, a + 350 + 300 * i, where, port))
    return trace.Summary(TICKS, 0, TICKS[-1][1], ops, [], 0, 0)


@pytest.mark.parametrize("per_tick,share", [(2, 100.0), (1, 50.0), (3, 150.0)])
def test_mppi_kernel_share_counts_the_kernels_launches_an_update(per_tick, share):
    cell = run.load_cell(ROOT, "mppi_t50-fleet4096")
    assert cell.config["solver"]["updates_per_tick"] == 2
    assert "mppi_kernel_share" in {m["name"] for m in cell.per_layer}
    assert entries.kernel_files(CSRC)["mppi_update_kernel"] == "mppi.cu"
    got = run.reader(ROOT, "mppi_kernel_share")(_mppi_slice(per_tick), cell)
    assert got == pytest.approx(share)


@pytest.mark.parametrize("kw", [dict(per_tick=0), dict(where="serve"), dict(port=False),
                                dict(name=REDUCE)],
                         ids=["none", "outside-the-solver", "not-the-ports", "another-kernel"])
def test_mppi_kernel_share_reads_nothing_without_the_kernel(kw):
    cell = run.load_cell(ROOT, "mppi_t50-fleet4096")
    assert run.reader(ROOT, "mppi_kernel_share")(_mppi_slice(**kw), cell) is None


def test_mppi_kernel_share_reads_nothing_for_a_program_without_the_file(monkeypatch,
                                                                       tmp_path):
    """A program with no ``csrc/mppi.cu``, as the parent of the kernel is,
    reads None rather than raising."""
    for p in CSRC.glob("*.cu"):
        if p.name != "mppi.cu":
            (tmp_path / p.name).write_text(p.read_text())
    monkeypatch.setattr(entries, "csrc", lambda: tmp_path)
    cell = run.load_cell(ROOT, "mppi_t50-fleet4096")
    assert run.reader(ROOT, "mppi_kernel_share")(_mppi_slice(), cell) is None
