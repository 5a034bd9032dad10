"""The port on the card: each hand-written CUDA kernel against its plain
version, the wrappers' refusals, and RolloutEngine.generate on the card
(kernels) against the CPU (plain versions) on the same weights. Every test
needs a CUDA device and skips without one (decided in the `card` fixture);
on a machine with a card run

    python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax, which the card's machine
need not have; this file imports only torch and repro_torch)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import gqa_decode as gqa
from repro_torch.kernels import ref
from repro_torch.kernels import sgmv
from repro_torch.launch.serve import make_adapters, make_requests
from repro_torch.models import init_params, tree_map
from repro_torch.rollout.engine import RolloutEngine

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_decode_matches_plain(card, hd, dtype, tol):
    q = torch.randn(4, 16, hd, generator=card, device="cuda").to(dtype)
    ck = torch.randn(4, 200, 8, hd, generator=card, device="cuda").to(dtype)
    cv = torch.randn(4, 200, 8, hd, generator=card, device="cuda").to(dtype)
    pos = torch.tensor([1, 57, 199, 200], dtype=torch.int32, device="cuda")
    for cap, win in ((0.0, 0), (50.0, 0), (0.0, 24)):
        got = gqa.gqa_decode(q, ck, cv, pos, softcap=cap, window=win)
        want = ref.gqa_decode_ref(q, ck, cv, pos, softcap=cap, window=win)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_sgmv_matches_plain_with_empty_groups(card, xdt):
    x = torch.randn(40, 1024, generator=card, device="cuda").to(xdt)
    a = torch.randn(4, 1024, 16, generator=card, device="cuda") / 32
    b = torch.randn(4, 16, 2048, generator=card, device="cuda") * 0.1
    ids = torch.tensor([0] * 20 + [3] * 20, dtype=torch.int32, device="cuda")
    torch.testing.assert_close(sgmv.sgmv(x, a, b, ids),
                               ref.sgmv_ref(x, a, b, ids), rtol=1e-5, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(2, 4, 48, device="cuda")
    cache = torch.zeros(2, 8, 2, 48, device="cuda")
    pos = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        gqa.gqa_decode(q, cache, cache, pos)
    with pytest.raises(ValueError, match="int32"):
        gqa.gqa_decode(q[..., :32].contiguous(), cache[..., :32].contiguous(),
                       cache[..., :32].contiguous(), pos.long())
    x = torch.zeros(4, 64, device="cuda")
    a = torch.zeros(2, 64, 4, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        sgmv.sgmv(x, a, torch.zeros(2, 4, 8, device="cuda"),
                  torch.zeros(4, dtype=torch.int32, device="cuda"))


def test_generate_on_card_matches_cpu(card):
    """qwen3-0.6b reduced (hd=16) in fp32: the same weights served on the
    card (kernels) and on the CPU (plain versions) give the same tokens, and
    the kernels launch once per layer per step (gqa_decode) and once per
    adapted projection per forward (sgmv)."""
    cfg = dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"], dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 2, seed=0, device="cpu", b_scale=0.2)
    reqs = make_requests(2, 3, max_new_tokens=8)
    res_cpu, _ = RolloutEngine(cfg, params, max_len=48, device="cpu").generate(
        reqs, adapters)
    gqa.LAUNCHES.n = sgmv.LAUNCHES.n = 0
    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)
    res_gpu, st = RolloutEngine(cfg, to_card(params), max_len=48,
                                device="cuda").generate(
        reqs, [to_card(t) for t in adapters])
    assert gqa.LAUNCHES.n == cfg.num_layers * st.decode_steps
    assert sgmv.LAUNCHES.n == 6 * cfg.num_layers * (st.decode_steps + 1)
    for a, b in zip(res_cpu, res_gpu):
        assert a["tokens"] == b["tokens"]
        torch.testing.assert_close(torch.tensor(b["gen_logprobs"]),
                                   torch.tensor(a["gen_logprobs"]),
                                   rtol=1e-4, atol=1e-4)
