"""The plain reference against the port's plain CPU path at a tiny size
(fp32): the same logits and the same GRPO update."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rlbench.harness import weights as builder
from rlbench.harness.weights import make_adapters, make_base, shape
from rlbench.reference.grpo import Hyper, Row, adam_init, grpo_step
from rlbench.reference.model import RefModel, quantize_fp8

TINY = json.loads((Path(__file__).parent / "tiny.json").read_text())
CFG = TINY["config"]


@pytest.fixture(scope="module")
def setup():
    s = shape(CFG)
    w = make_base(CFG, 123, "cpu")
    ad = make_adapters(CFG, 2, 123, "cpu")
    return s, w, ad


def test_logits_equal_the_ports(setup):
    from repro_torch.lora.adapters import single_ctx
    from repro_torch.models import forward_train
    s, w, ad = setup
    pcfg = builder.port_config(CFG)
    tok = torch.randint(8, s.vocab, (40,), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = forward_train(builder.port_params(w), tok[None], pcfg,
                                single_ctx({"layers": ad[1]}, pcfg))
        ref = RefModel(CFG, w)
        got = ref.logits(ref.hidden(tok, ad[1]))
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=1e-5)
    lp, gap, top = ref.next_token_stats(tok, 10, ad[1], chunk=7)
    z = want[0, 9:39]
    torch.testing.assert_close(lp, torch.log_softmax(z, -1).gather(
        1, tok[10:, None])[:, 0], rtol=1e-5, atol=1e-5)
    assert torch.equal(top, z.argmax(-1))
    assert float(gap.min()) >= 0


def test_grpo_update_equals_the_ports(setup):
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, init_opt_state, make_train_step
    s, w, ad = setup
    pcfg = builder.port_config(CFG)
    rng = np.random.default_rng(3)
    R, S, P = 4, 32, 12
    lens = [32, 30, 25, 32]
    tokens = rng.integers(8, s.vocab, (R, S)).astype(np.int32)
    for j, n in enumerate(lens):
        tokens[j, n:] = 0
    beh = rng.normal(-6.0, 0.3, (R, S - 1)).astype(np.float32)
    rewards = np.array([0.1, 0.5, 0.2, 0.9], np.float32)
    tc = TrainConfig(group_size=4, is_cap=2.0, adamw=AdamWConfig(lr=3e-3))
    step = make_train_step(pcfg, tc)
    tree = {"layers": ad[0]}
    batch = {"tokens": torch.as_tensor(tokens),
             "prompt_lens": torch.full((R,), P, dtype=torch.int32),
             "total_lens": torch.as_tensor(np.array(lens, np.int32)),
             "rewards": torch.as_tensor(rewards),
             "behavior_logprobs": torch.as_tensor(beh)}
    new, opt, m = step(builder.port_params(w), tree, init_opt_state(pcfg, tc, None, tree),
                       batch)
    rows = [Row(tokens[j, :n].tolist(), P, [1.0] * (n - P), float(rewards[j]),
                beh[j, P - 1:n - 1].tolist()) for j, n in enumerate(lens)]
    ref = RefModel(CFG, w)
    loss, grads, new_ref, opt_ref = grpo_step(ref, ad[0], adam_init(ad[0]), rows,
                                              4, Hyper(lr=3e-3))
    assert loss == pytest.approx(float(m["loss"]), abs=1e-5)
    for t in ad[0]:
        for k in ("a", "b"):
            torch.testing.assert_close(opt["m"]["layers"][t][k] / 0.1,
                                       grads[t][k], rtol=1e-4, atol=1e-7)
            torch.testing.assert_close(new["layers"][t][k], new_ref[t][k],
                                       rtol=1e-4, atol=1e-6)


def test_fp8_control_rounds_to_e4m3():
    w = torch.tensor([[1.0, -448.0], [0.1, 3.0], [1.06, 100.0]])
    q = quantize_fp8(w, dim=0)
    # column 0: amax 1.06 -> 448; column 1 exact at its amax
    assert q[2, 0] == pytest.approx(1.06, rel=1e-6)
    assert q[0, 1] == -448.0
    assert float((q - w).abs().max()) > 0
    assert float(((q - w).abs() / w.abs()).max()) <= 1 / 16 + 1e-6
