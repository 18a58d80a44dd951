"""The traffic generator: the same requests from the same seed, other ones
from another, and the same lengths and gaps in every whole block."""

import json
from pathlib import Path

import numpy as np
import pytest

from h100bench import traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat-closed64", "docqa-open", "sysprompt-open"])
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a = traffic.generate(mix, 32000, 2**31 + 7, 3 * mix["block"])
    b = traffic.generate(mix, 32000, 2**31 + 7, 3 * mix["block"])
    c = traffic.generate(mix, 32000, 2**31 + 8, 3 * mix["block"])
    assert [(x.prompt, x.max_new, x.due) for x in a] == [(x.prompt, x.max_new, x.due) for x in b]
    assert [x.prompt for x in a] != [x.prompt for x in c]
    # every whole block holds the same lengths (and gaps) whatever the seed
    assert sorted(len(x.prompt) for x in a) == sorted(len(x.prompt) for x in c)
    assert sorted(x.max_new for x in a) == sorted(x.max_new for x in c)
    assert [x.max_new for x in a] != [x.max_new for x in c]
    if mix["loop"] == "open":
        assert a[0].due == 0.0
        # whole blocks of the same gaps: the sums differ only by each run's first gap
        longest = np.log(2 * mix["block"]) / mix["rate"]
        assert abs(a[-1].due - c[-1].due) <= longest


@pytest.mark.parametrize("name", ["chat-closed64", "docqa-open", "sysprompt-open"])
def test_lengths_follow_the_file(name):
    mix = _mix(name)
    items = traffic.generate(mix, 32000, 11, 2 * mix["block"])
    pre = mix.get("prefix", {}).get("tokens", 0)
    turns = np.array([len(x.prompt) - pre for x in items])
    assert turns.min() >= mix["prompt"]["min"] and turns.max() <= mix["prompt"]["max"]
    assert (turns % mix["prompt"].get("multiple_of", 1) == 0).all()
    outs = np.array([x.max_new for x in items])
    assert outs.min() >= mix["output"]["min"] and outs.max() <= mix["output"]["max"]
    assert min(min(x.prompt) for x in items) >= 1  # id 0 is the engine's padding


def test_prefix_shares_and_rate():
    mix = _mix("sysprompt-open")
    items = traffic.generate(mix, 32000, 5, mix["block"])
    counts = np.bincount([x.prefix for x in items], minlength=mix["prefix"]["count"])
    assert counts.tolist() == traffic.share_counts(mix["prefix"]["shares"], mix["block"])
    heads = {tuple(x.prompt[:mix["prefix"]["tokens"]]) for x in items}
    assert len(heads) == mix["prefix"]["count"]
    doc = _mix("docqa-open")
    due = [x.due for x in traffic.generate(doc, 32000, 5, 20 * doc["block"])]
    assert abs(len(due) / due[-1] - doc["rate"]) < 0.05 * doc["rate"]


def test_quantiles_by_hand():
    q = traffic.quantiles({"dist": "uniform", "min": 10, "max": 20}, 5)
    assert q.tolist() == [11, 13, 15, 17, 19]
    q = traffic.quantiles({"dist": "uniform", "min": 64, "max": 512, "multiple_of": 64}, 4)
    assert q.tolist() == [128, 256, 384, 512]  # 120, 232, 344, 456 rounded up to whole pages
    assert traffic.share_counts([0.55, 0.25, 0.12, 0.08], 50) == [28, 12, 6, 4]
    np.testing.assert_allclose(traffic.exp_gaps(2.0, 4), -np.log1p(-(np.arange(4) + 0.5) / 4) / 2.0)
