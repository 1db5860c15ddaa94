"""A whole run of each cell at a tiny size on the CPU, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false, once for each fault the cell can
have (a step that leaves its state as it was, half of the batch left out
with the mean over the rest, a token altered where it is produced; one
card, so no exchange between cards to leave out). With routed experts in
every layer, the same, and a router that takes a wrong expert for every
fourth token fails on the routing's own check."""

from __future__ import annotations

import pytest

import tiny
from pbench.harness import run_cell

SEED = 2**31 + 99
TRAIN = ["mistral-7b.train-l8192"]
SERVE = ["mistral-7b.prefill-longdoc"]
CASES = ([(c, p) for c in TRAIN for p in ("none", "state", "half", "token")]
         + [(c, p) for c in SERVE for p in ("none", "state", "token")])


@pytest.mark.parametrize("cell,plant", CASES)
def test_a_run_is_correct_unless_broken(cell, plant):
    result, out = run_cell(tiny.cell(cell), SEED, 0.5, False, "cpu", plant)
    assert result["correct"] is (plant == "none"), result["checks"]
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


ROUTED = ([(c, p) for c in TRAIN for p in ("none", "state", "half", "token", "route")]
          + [(c, p) for c in SERVE for p in ("none", "state", "token", "route")])


@pytest.mark.parametrize("cell,plant", ROUTED)
def test_a_routed_run_is_correct_unless_broken(cell, plant):
    result, out = run_cell(tiny.cell(cell, experts=(4, 2)), SEED + 3, 0.5, False, "cpu", plant)
    checks = result["checks"]
    assert result["correct"] is (plant == "none"), checks
    assert 0.0 <= out["readings"]["route_flip_share"] <= 1.0
    if plant == "route":  # the routing's check fails; what follows the replayed routing need not
        assert checks["route_margin"]["value"] > checks["route_margin"]["limit"]


@pytest.mark.parametrize("experts", [None, (4, 2)])
def test_int8_weights_are_served_and_the_int4_control_reads_wider(experts):
    widest = {}
    for plant in ("none", "control"):
        c = tiny.cell("mistral-7b.prefill-longdoc", experts=experts)
        c.config["weights"] = "int8"
        c.workload["control_precision"] = "int4"
        result, _ = run_cell(c, SEED + 4, 0.5, False, "cpu", plant)
        if plant == "none":
            assert result["correct"], result["checks"]
        widest[plant] = max(result["checks"][n]["value"] for n in ("logit_gap", "logprob_gap"))
    # the tiny limits are the cells' own readings at bf16, too loose to fail
    # every int4 control here: the control's gaps stand well above the sound run's
    assert widest["control"] > widest["none"] + 0.1, widest


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_a_traced_run_reads_its_window(cell):
    result, out = run_cell(tiny.cell(cell), SEED + 1, 0.9, True, "cpu")
    assert result["correct"]
    dev = result["device"]
    # training traces its whole window; serving traces a third of it (the
    # card alone: on the CPU, the host), then the host, and reads the
    # host's numbers in the untraced part before them
    lo, hi = (0.6, 3.0) if cell in TRAIN else (0.2, 0.6)
    assert lo < dev["window_s"] < hi and dev["busy_s"] == 0  # no device operation on the CPU
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in tiny.spec.cell(cell).per_layer}
    assert set(result["metrics"]) <= names
    if cell in SERVE:
        assert {"mfu.serve", "chunk_enqueue_ms.serve"} <= set(result["metrics"])
        assert result["breakdown"]["idle_gaps"]


def test_the_result_line():
    import io
    import json

    from pbench.harness import emit

    result, _ = run_cell(tiny.cell("mistral-7b.train-l8192"), SEED + 2, 0.3, False, "cpu",
                         "state")
    out, err = io.StringIO(), io.StringIO()
    emit(result, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is False
    assert {"train_tokens_per_s", "setup_s"} == set(line["metrics"])
    assert err.getvalue().splitlines()[-1].startswith("check update_gap: 1.0 (limit")
