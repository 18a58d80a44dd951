"""A cell cut to a size the CPU runs in seconds, for the tests: widths like
``ModelConfig.smoke()``'s in float32 (float32 pools too, so that the program
and the reference agree to rounding), a small engine, short prompts and
answers. The traffic keeps its loop, its sharing and its whole pages."""

import copy


def small_cell(cell, window=None):
    c = copy.deepcopy(cell)
    m = c.config["model"]
    m.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
             n_experts=min(m.get("n_experts", 0), 4), kv_page_tokens=8, compute_dtype="float32",
             kv_cache_dtype="float32", sliding_window=window)
    c.config["engine"] = {"max_slots": 4, "n_pages": 4096, "max_pages_per_seq": 16}
    t = c.traffic
    t["output"] = {"dist": "uniform", "min": 3, "max": 12}
    if "prefix" in t:
        t["prefix"]["tokens"] = 24
        t["prompt"] = {"dist": "uniform", "min": 8, "max": 24, "multiple_of": 8}
    else:
        t["prompt"] = {"dist": "uniform", "min": 8, "max": 64, "multiple_of": 8}
    if t["loop"] == "closed":
        t.update(clients=4, stagger_s=0.2, ramp_s=0.5, requests=256)
    else:
        t.update(rate=60.0, warmup_s=0.5)
    c.limits["sample_tokens"] = 80
    return c
