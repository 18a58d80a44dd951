"""``correct``: the plain reference against the port's plain path, a whole
small run judged true, the control above the program, and runs with the
timed path broken underneath judged false.

At this size the program runs float32 (pools too) on the CPU, so its served
tokens are the reference's own (gap 0). The limits in ``limits/`` were set
from readings on the card at the cells' own sizes (PERF.md); here a broken
run must read far above them."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100bench import check, run, spec, weights
from small_cells import small_cell

CELLS = ["mixtral-chat", "danube-docqa", "danube-sysprompt"]
SEED = 2**31 + 3


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("window", [None, 16])
def test_reference_matches_the_port(name, window):
    from repro_torch.models.lm import build_model, serving_params

    cell = small_cell(spec.load_cell(name), window)
    model = cell.config["model"]
    cfg = run.model_config(cell)
    params = weights.draw(model, 5, "cpu")
    toks = torch.randint(1, model["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(1))
    mine, _ = build_model(cfg).prefill(serving_params(params, cfg), toks)
    ref = spec.reference_module(cell.config)
    theirs = ref.logits(params, model, [toks[0]], [slice(39, 40)])[0]
    torch.testing.assert_close(mine[:, : model["vocab_size"]], theirs, rtol=1e-4, atol=1e-4)


def _run(name, **kw):
    cell = small_cell(spec.load_cell(name))
    return run.run_cell(cell, SEED, 2.0, False, torch.device("cpu"), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_small_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["check"]
    assert all(c["value"] == 0 for c in result["check"].values())
    assert list(result)[-1] == "check"


def test_control_reads_above_the_program():
    """The fp8 reference put in the program's place misses the float32
    reference's best token by far more than the program does."""
    cell = small_cell(spec.load_cell("mixtral-chat"))
    model = cell.config["model"]
    dev = torch.device("cpu")
    ref = spec.reference_module(cell.config)
    for seed in (1, 2, 3):
        params = weights.draw(model, seed, dev)
        obs, _ = run.serve_window(cell, params, seed, 2.0, False, dev, 0.0)
        picked = check.sample(obs, cell.limits, seed)
        program = check.numbers(obs, check.reference_gaps(ref, params, model, picked, dev))["gap_max"]
        control = max(float(g.max()) for g in check.control_gaps(ref, params, model, picked, dev))
        assert control > 0.0 and program * 3 <= control


@pytest.mark.parametrize("name", ["danube-docqa", "danube-sysprompt"])
def test_the_control_is_judged_not_correct(name):
    """The control's tokens put through the harness's own comparison
    (``numbers``, ``verdict``, ``passed``) against the cell's committed
    limits read not correct, while the program's read correct. mixtral-chat
    is judged on the card alone (below): at this size its fp8 control's
    ``gap_p90`` (0.06-0.29) stays under the limit set at the cell's own size."""
    cell = small_cell(spec.load_cell(name))
    model = cell.config["model"]
    dev = torch.device("cpu")
    ref = spec.reference_module(cell.config)
    params = weights.draw(model, SEED, dev)
    obs, _ = run.serve_window(cell, params, SEED, 2.0, False, dev, 0.0)
    picked = check.sample(obs, cell.limits, SEED)
    program = check.verdict(check.numbers(obs, check.reference_gaps(ref, params, model, picked, dev)), cell.limits)
    control = check.verdict(check.numbers(obs, check.control_gaps(ref, params, model, picked, dev)), cell.limits)
    assert check.passed(program), program
    assert not check.passed(control), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_judged_not_correct_on_the_card(name, tmp_path):
    """At the cell's own size and load on the card (``control.py``, one seed,
    a window that finishes the mix's longest requests), the program reads
    correct and the fp8 control not, each judged against the committed limits."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "h100bench/control.py", "--workload", name, "--seeds", str(SEED + 100),
                          "--seconds", "20"], cwd=root, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    print(json.dumps(line))
    assert line["correct"], line["check"]
    assert not line["control_correct"], line["control_check"]


def _break_state(monkeypatch):
    """A decode step that leaves the pools as they were: no token's K/V is written."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "paged_update", lambda pk, pv, tables, page_pos, *a, **kw: (pk, pv, page_pos))


def _break_half_batch(monkeypatch):
    """A decode step that runs the first half of the rows; the rest get the mean of their logits."""
    from repro_torch.serving import engine as engine_mod

    build = engine_mod.build_model

    def broken(cfg):
        m = build(cfg)

        def decode_step(params, cache, tokens, **kw):
            logits, cache = m.decode_step(params, cache, tokens, **kw)
            half = logits.shape[0] // 2
            return torch.cat([logits[:half], logits[:half].mean(0, keepdim=True).expand_as(logits[half:])]), cache
        return dataclasses.replace(m, decode_step=decode_step)

    monkeypatch.setattr(engine_mod, "build_model", broken)


def _break_token(monkeypatch):
    """Every fifth token the engine samples is altered where it is produced."""
    from repro_torch.serving.engine import ServingEngine

    inner, calls = ServingEngine._sample, [0]

    def sample(self, logits, temperature):
        calls[0] += 1
        tok = inner(self, logits, temperature)
        return (tok + 1) % self.cfg.vocab_size if calls[0] % 5 == 0 else tok

    monkeypatch.setattr(ServingEngine, "_sample", sample)


@pytest.mark.parametrize("fault", [_break_state, _break_half_batch, _break_token])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(name)
    assert not result["correct"], result["check"]
    assert any(c["value"] > c["limit"] for c in result["check"].values())
