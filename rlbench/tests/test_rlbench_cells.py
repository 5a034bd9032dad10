"""Cells by name, from BENCHMARK.json and the files it names."""
import pytest

from rlbench import run as R
from rlbench.harness import cell as cells


def test_every_cell_loads_by_name(root, bench):
    for w in bench["workloads"]:
        c = cells.load_cell(root, w["name"])
        assert c.name == w["name"]
        assert c.mix == w["traffic"]
        assert c.chips == w["chips"] == 1
        assert c.shape.layers == c.config["num_hidden_layers"]
        assert c.traffic["max_len"] % c.config["kv_page_size"] == 0
        assert set(c.limits) >= {"greedy_gap", "logprob_gap", "grad_gap",
                                 "update_gap"}


def test_unknown_cell_raises(root):
    with pytest.raises(KeyError):
        cells.load_cell(root, "qwen3-0.6b.no-such-mix")


def test_metrics_follow_their_workloads_key(bench):
    names = [m["name"] for m in cells.metrics_for(
        bench, "qwen3-0.6b.other-mix", "per_layer")]
    assert "prefix_hit_pct" not in names
    assert "token_gap_p95_ms.shared-prompt" not in names
    assert "mfu" in names
    shared = [m["name"] for m in cells.metrics_for(
        bench, "qwen3-0.6b.shared-prompt", "per_layer")]
    assert "prefix_hit_pct" in shared
    assert "token_gap_p95_ms.shared-prompt" in shared


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(R.reader(m["name"]))
    # a name split per cell reads with its metric's reader
    assert R.reader("token_gap_p95_ms.shared-prompt").__module__.endswith(
        "token_gap_p95_ms")


@pytest.mark.parametrize("name", ["qwen3-0.6b.shared-prompt"])
def test_prompts_fit_the_ports_prefill_and_train_shapes(root, name):
    """The port's sequence attention takes a query over 512 tokens only in
    whole chunks of 512 (models/attention.attention_chunked), and the
    trainer pads every row to max_len: no prompt and no max_len may fall
    between."""
    c = cells.load_cell(root, name)
    t = c.traffic
    longest = t["system_prompt_tokens"] + max(t["problem_tokens"])
    for n in (longest, t["max_len"]):
        assert n <= 512 or n % 512 == 0
    assert longest + max(t["output_budgets"]) <= t["max_len"]
