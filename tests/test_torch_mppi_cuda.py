"""``MPPIService`` on the card against the benchmark's plain reference
(``portbench/reference/mppi.py``) at the cell's widths: B 64 plants, K 512
candidates, H 50 steps, two updates a tick.

Each of four ticks is re-solved by the reference from the warm state the
service held (its words and its noise; the first tick's the cold-row
table) and the states it was sent, full float32 products: the carried
plans and the returned controls differ from the reference's in no more
problems than ``portbench/configs/mppi_t50.json``'s limits allow, the
noise is int8 inside +-127 and on the card, and the controls are inside
the box.

The update's kernel (``csrc/mppi.cu`` through ``mppi_update_fused``)
against its plain version (``mppi_update_plain``) on the card, words and
best costs bit for bit (as int32 bits): at B 64 and 4,096 with K 512 and H
50, at K 32, 256 and 1,024 and a short horizon, with nominal lanes and noise
at +-127 (every lane saturates), with start angles past a half turn and at
int32's ends (theta wraps), and on noise that is int32, a strided view of
``draw_noise``'s slab, or 4 bytes off a 16-byte boundary; one launch an
update, and the service's ticks and ``step`` through it.

Every test needs an NVIDIA GPU and skips without one.  This file imports
neither jax nor pint_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_mppi_cuda.py
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import pint_tpu_torch as pt
from pint_tpu_torch.models.dynamics import pack_controls, unpack_controls
from pint_tpu_torch.mpc import mppi as M
from pint_tpu_torch.mpc.mppi import (QuantizedMPPI, mppi_update_fused, mppi_update_plain,
                                     unicycle_goal_cost)
from portbench import compare
from portbench.kinds import mppi as kind

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench/configs/mppi_t50.json").read_text())


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    compare.set_precision(False)
    return torch.device("cuda")


def test_service_ticks_match_the_plain_reference_on_the_card(cuda):
    B = 64
    config = copy.deepcopy(CONFIG)
    s = config["solver"]
    assert (s["horizon"], s["samples"], s["updates_per_tick"]) == (50, 512, 2)
    svc = kind.build(config, B, "cuda")
    r = kind.Reference(config, "cuda")
    limits = config["limits"]
    box = CONFIG["initial_states"]
    rng = np.random.default_rng(2016)
    for t in range(4):
        x = rng.uniform(box["low"], box["high"], (B, 3))
        words, noise = svc._warm
        assert noise.device.type == "cuda" and noise.dtype == torch.int8
        assert noise.shape == (B, 2, 512, 100) and int(noise.abs().max()) <= 127
        u = svc.solve(x)
        want = r.step(torch.as_tensor(x.astype(np.float32), device="cuda"),
                      {"words": words, "noise": noise})["words"]
        carried = r.lanes(r.shift({"words": want})["words"])
        assert compare._diff_pct(r.lanes(svc._warm[0]), carried) <= limits["plan_diff_pct"]
        lanes = torch.as_tensor(np.rint(u / r.lane_scales).astype(np.int32), device="cuda")
        assert compare._diff_pct(lanes, r.lanes(want)[:, :2]) <= limits["control_diff_pct"]
        assert int(lanes.abs().max()) <= 127


# -- the update's kernel against its plain version ------------------------------------


def _operands(B, K, H, seed, *, extremes=False, wrap=False):
    """A solver on the card, start states in the cell's box (or past a half
    turn and at int32's ends), warm words and one update's int8 noise."""
    mppi = QuantizedMPPI(horizon=H, samples=K, device="cuda")
    rng = np.random.default_rng(seed)
    box = CONFIG["initial_states"]
    state = pt.Unicycle().to_fixed(rng.uniform(box["low"], box["high"], (B, 3))
                                   .astype(np.float32))
    if wrap:
        state[:, 2] = rng.choice([2**15 - 3, 2**15 + 5, 3 * 2**14 + 7, 2**31 - 40, -2**31 + 9,
                                  -2**15 - 1], B)
    if extremes:
        lanes = rng.choice([-127, 127], (B, 2 * H))
        noise = torch.as_tensor(rng.choice([-127, 127], (B, K, 2 * H)), dtype=torch.int8)
    else:
        lanes = rng.integers(-60, 61, (B, 2 * H))
        noise = mppi.draw_noise(torch.Generator().manual_seed(seed), B, 1)[:, 0].cpu()
    words = pack_controls(torch.as_tensor(lanes, dtype=torch.int32)).cuda()
    return (mppi, words, noise.cuda(), torch.as_tensor(state).cuda(),
            unicycle_goal_cost(mppi.model, torch.tensor(CONFIG["solver"]["goal"], device="cuda")))


def _bits_equal(got, want):
    words, best = got
    w_words, w_best = want
    assert torch.equal(words, w_words), int((words != w_words).sum())
    assert torch.equal(best.view(torch.int32), w_best.view(torch.int32))


@pytest.mark.parametrize("B,K,H", [(64, 512, 50), (4096, 512, 50), (64, 256, 50),
                                   (37, 1024, 50), (33, 32, 8), (100, 128, 2)])
def test_update_kernel_is_its_plain_version(cuda, B, K, H):
    args = _operands(B, K, H, B + K + H)
    M.K.reset_launch_counts()
    got = mppi_update_fused(*args)
    assert M.launch_count() == 1
    _bits_equal(got, mppi_update_plain(*args))


@pytest.mark.parametrize("extremes,wrap", [(True, False), (False, True), (True, True)])
def test_update_kernel_saturates_and_wraps(cuda, extremes, wrap):
    args = _operands(256, 512, 50, 7, extremes=extremes, wrap=wrap)
    got = mppi_update_fused(*args)
    _bits_equal(got, mppi_update_plain(*args))
    assert int(unpack_controls(got[0]).abs().max()) <= 127


def test_update_kernel_reads_any_noise_layout(cuda):
    mppi, words, noise, state, cost = _operands(64, 512, 50, 8)
    want = mppi_update_plain(mppi, words, noise, state, cost)
    _bits_equal(mppi_update_fused(mppi, words, noise.to(torch.int32), state, cost), want)
    slab = torch.stack([noise, noise.flip(0)], 1)                 # (B, 2, K, L)
    _bits_equal(mppi_update_fused(mppi, words, slab[:, 0], state, cost), want)
    off = torch.empty(noise.numel() + 4, dtype=torch.int8, device="cuda")[4:]
    off.copy_(noise.reshape(-1))
    assert off.data_ptr() % 16 == 4
    _bits_equal(mppi_update_fused(mppi, words, off.view(noise.shape), state, cost), want)


def test_solve_words_and_step_launch_once_an_update(cuda):
    mppi, words, _, state, cost = _operands(128, 512, 50, 9)
    noise = mppi.draw_noise(torch.Generator(device="cuda").manual_seed(9), 128, 2)
    M.K.reset_launch_counts()
    got = mppi.solve_words(words, state, noise, cost)
    assert M.launch_count() == 2
    want = words
    for u in range(2):
        want, _ = mppi_update_plain(mppi, want, noise[:, u], state, cost)
    assert torch.equal(got, want)
    M.K.reset_launch_counts()
    mppi.step(torch.Generator(device="cuda").manual_seed(10), got, state, cost)
    assert M.launch_count() == 1


def test_service_ticks_run_the_kernel(cuda):
    svc = kind.build(copy.deepcopy(CONFIG), 64, "cuda")
    box = CONFIG["initial_states"]
    rng = np.random.default_rng(11)
    M.K.reset_launch_counts()
    for _ in range(3):
        svc.solve(rng.uniform(box["low"], box["high"], (64, 3)))
    assert M.launch_count() == 3 * CONFIG["solver"]["updates_per_tick"]
