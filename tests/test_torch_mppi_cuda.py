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
