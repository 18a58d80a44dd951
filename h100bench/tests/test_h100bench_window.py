"""The window arithmetic of the end-to-end metrics, over every request,
with the ones never admitted counted, on observations made by hand."""

from h100bench import spec
from h100bench.run import attempted_failed
from h100bench.serve import Obs, Req, Step
from h100bench.traffic import Item


def _obs(loop):
    # steps at 0..9 s, one second each; the window is [2, 8)
    rows = [1, 2, 3, 3, 4, 4, 4, 2, 2, 1]
    done = [0, 0, 1, 0, 1, 0, 2, 0, 1, 1]
    steps = [Step(float(i), i + 1.0, r, c) for i, (r, c) in enumerate(zip(rows, done))]
    return Obs({}, loop, 2.0, 8.0, steps, {})


def test_output_tokens_count_first_tokens():
    obs = _obs("closed")
    assert obs.window_steps() == [2, 3, 4, 5, 6, 7]
    assert obs.window_span() == (2.0, 8.0)
    # admitted in step i: its rows less the rows left running after step i-1
    assert [obs.admitted(i) for i in obs.window_steps()] == [1, 1, 1, 1, 0, 0]
    read = spec.reader("e2e", "output_tok_s")
    assert read(obs) == (3 + 3 + 4 + 4 + 4 + 2 + 1 + 1 + 1 + 1 + 0 + 0) / 6.0


def _req(rid, due, first, end=None, n=4, latency=None):
    r = Req(Item(rid, [1, 2], n), submit=due + 0.01, due=due)
    if first is not None:
        r.first, r.end, r.tokens, r.latency_s = first, end, [0] * n, latency
    return r


def test_ttft_counts_late_and_never_admitted():
    obs = _obs("open")
    obs.reqs = {0: _req(0, 1.0, 1.5, 3.0),  # due before the window: not counted
                1: _req(1, 2.0, 2.1, 4.0), 2: _req(2, 3.0, 3.5, 6.0), 3: _req(3, 4.0, 4.2, 6.0),
                4: _req(4, 5.0, 9.0, 9.5),  # first token after the window's end: censored, failed
                5: _req(5, 7.5, None),  # never admitted: censored, failed
                6: _req(6, 8.5, 8.6, 9.0)}  # due after the window
    assert attempted_failed(obs) == (5, 2)
    ttft = sorted([0.1, 0.5, 0.2, 8.0 - 5.0, 8.0 - 7.5])
    import numpy as np

    assert spec.reader("e2e", "ttft_p90_ms")(obs) == float(np.percentile(ttft, 90)) * 1e3


def test_tpot_counts_requests_completed_in_window():
    obs = _obs("closed")
    obs.reqs = {0: _req(0, 0.0, 0.5, 2.0, n=5, latency=0.4),  # completed before the window opened
                1: _req(1, 1.0, 1.5, 5.0, n=5, latency=4.0), 2: _req(2, 3.0, 3.2, 8.0, n=3, latency=1.0),
                3: _req(3, 6.0, 6.5, 9.0, n=3, latency=2.0)}  # completed after it
    import numpy as np

    assert spec.reader("e2e", "tpot_p90_ms")(obs) == float(np.percentile([1.0, 0.5], 90)) * 1e3
    obs.reqs[4] = _req(4, 2.5, None)
    obs.reqs[4].submit = 2.5
    assert attempted_failed(obs) == (3, 0)  # sent in the window: 2, 3 and 4; a closed loop fails none
