"""The port on the card: each hand-written CUDA kernel against its plain
version, the wrappers' refusals, and RolloutEngine.generate, a GRPO train
step and the paged ContinuousRolloutEngine (with private pages and with the
prefix cache: a COW fork under the paged kernel, a radix install through
sgmv) on the card (kernels) against the CPU (plain versions) on the same
weights. Every test is marked `cuda`, needs a CUDA device and skips
without one (decided in the `card` fixture); on a machine with a card run

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
from repro_torch.kernels import paged_decode as paged
from repro_torch.kernels import ref
from repro_torch.kernels import sgmv
from repro_torch.kernels import token_logprob as tlp
from repro_torch.launch.serve import make_adapters, make_requests
from repro_torch.models import init_params, tree_leaves, tree_map
from repro_torch.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                        to_trajectory_batch)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                          init_opt_state, make_train_step)

pytestmark = pytest.mark.cuda

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


def _sgmv_case(card, R, T, d, r, dout, xdt, kind):
    """Rows, adapters (fp32) and slot ids: `kind` "empty" leaves slots 1
    and 2 without rows, "each" gives every row its own slot (T = R)."""
    x = torch.randn(R, d, generator=card, device="cuda").to(xdt)
    a = torch.randn(T, d, r, generator=card, device="cuda") / d ** 0.5
    b = torch.randn(T, r, dout, generator=card, device="cuda") * 0.1
    if kind == "each":
        ids = torch.randperm(T, generator=card, device="cuda")[:R]
    elif kind == "empty":
        ids = torch.tensor([0, 3], device="cuda")[
            torch.randint(0, 2, (R,), generator=card, device="cuda")]
    else:
        ids = torch.randint(0, T, (R,), generator=card, device="cuda")
    return x, a, b, ids.to(torch.int32)


def _assert_add_close(got, want, y0, delta):
    """Epilogue b against its plain version: fp32 rows at rtol 1e-5, atol
    1e-4; bf16 rows may also differ by one bf16 step (2^-7 of the value) of
    the delta's and the sum's rounding, where the two fp32 products differ
    in their last bits and round the other way."""
    err = (got.float() - want.float()).abs()
    tol = 1e-4 + 1e-5 * want.float().abs()
    if got.dtype == torch.bfloat16:
        top = torch.maximum(got.float().abs(), want.float().abs())
        tol = tol + 2.0 ** -7 * (top + delta.abs())
    assert bool((err <= tol).all()), float(err.max())


SGMV_CASES = [  # R, T, d, r, dout, kind
    (16, 4, 1024, 16, 6144, "uniform"),     # decode, mlp_in
    (16, 4, 3072, 16, 1024, "empty"),       # decode, mlp_out, empty slots
    (16, 16, 1024, 16, 2048, "each"),       # one row a slot
    (40, 4, 1024, 16, 1000, "empty"),       # ragged dout
    (37, 5, 72, 4, 100, "uniform"),         # ragged d slices, rank 4
    (128, 4, 2048, 8, 1028, "uniform"),     # prefill rows, rank 8
    (300, 16, 1024, 32, 512, "uniform"),    # several tiles a slot, rank 32
    (2048, 4, 1024, 16, 6144, "uniform"),   # a continuous-prefill size
]


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,T,d,r,dout,kind", SGMV_CASES)
def test_sgmv_both_epilogues_match_plain(card, R, T, d, r, dout, kind, xdt):
    """sgmv (epilogue a) against sgmv_ref at fp32 1e-5 / 1e-4; sgmv_add_
    (epilogue b) bit-equal to a's output followed by the torch composition
    and close to sgmv_add_ref; one CUDA launch a call; two calls the same
    bits."""
    x, a, b, ids = _sgmv_case(card, R, T, d, r, dout, xdt, kind)
    table = sgmv.sgmv_table(ids, T)
    n = sgmv.CUDA_LAUNCHES.n
    got = sgmv.sgmv(x, a, b, ids, table=table)
    assert sgmv.CUDA_LAUNCHES.n - n == 1
    want = ref.sgmv_ref(x, a, b, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(sgmv.sgmv(x, a, b, ids, table=table), got)
    assert torch.equal(sgmv.sgmv(x, a, b, ids), got)   # a table built per call
    s = 0.37
    y0 = torch.randn(R, dout, generator=card, device="cuda").to(xdt)
    y = y0.clone()
    n = sgmv.CUDA_LAUNCHES.n
    assert sgmv.sgmv_add_(y, x, a, b, table, s) is y
    assert sgmv.CUDA_LAUNCHES.n - n == 1
    assert torch.equal(y, y0 + (got * s).to(xdt))
    again = sgmv.sgmv_add_(y0.clone(), x, a, b, table, s)
    assert torch.equal(again, y)
    _assert_add_close(y, ref.sgmv_add_ref(y0.clone(), x, a, b, ids, s), y0,
                      want * s)


@pytest.mark.parametrize("S", [1, 8])
def test_sgmv_add_over_sequences_matches_the_delta(card, S):
    """A table of per-sequence ids with S rows each: sgmv_add_ equals y
    plus multi_lora_delta's [B, S, dout] delta to the bit."""
    B, T, d, r, dout = 16, 4, 1024, 16, 2048
    x = torch.randn(B, S, d, generator=card, device="cuda").to(torch.bfloat16)
    a = torch.randn(T, d, r, generator=card, device="cuda") / 32
    b = torch.randn(T, r, dout, generator=card, device="cuda") * 0.1
    ids = torch.randint(0, T, (B,), generator=card, device="cuda")
    y0 = torch.randn(B, S, dout, generator=card, device="cuda").to(torch.bfloat16)
    from repro_torch.lora.multilora import multi_lora_delta
    want = y0 + multi_lora_delta(x if S > 1 else x[:, 0], a, b, ids,
                                 0.5).reshape(B, S, dout)
    y = y0.clone()
    sgmv.sgmv_add_(y.view(B * S, dout), x.reshape(B * S, d), a, b,
                   sgmv.sgmv_table(ids, T, S), 0.5)
    assert torch.equal(y, want)


def test_sgmv_graph_replay_gives_eager_bits(card):
    """Both epilogues captured in a CUDA graph: replays give the eager
    calls' bits."""
    x, a, b, ids = _sgmv_case(card, 16, 4, 1024, 16, 6144, torch.bfloat16,
                              "uniform")
    table = sgmv.sgmv_table(ids, 4)
    y0 = torch.randn(16, 6144, generator=card, device="cuda").to(torch.bfloat16)
    eager = sgmv.sgmv(x, a, b, ids, table=table)
    eager_y = sgmv.sgmv_add_(y0.clone(), x, a, b, table, 0.25)
    out = torch.empty_like(eager)
    y = y0.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(sgmv.sgmv(x, a, b, ids, table=table))
        sgmv.sgmv_add_(y, x, a, b, table, 0.25)
    for _ in range(2):
        out.zero_()
        y.copy_(y0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager) and torch.equal(y, eager_y)


def test_sgmv_refuses_autograd(card):
    """The kernel has no backward: a card call whose operands autograd
    tracks raises instead of dropping their gradients; under no_grad it
    runs."""
    x, a, b, ids = _sgmv_case(card, 8, 2, 64, 4, 32, torch.float32, "uniform")
    table = sgmv.sgmv_table(ids, 2)
    y = torch.zeros(8, 32, device="cuda")
    for args in ((x.requires_grad_(True), a, b), (x.detach(), a.requires_grad_(True), b)):
        with pytest.raises(RuntimeError, match="no backward"):
            sgmv.sgmv(*args, ids)
        with pytest.raises(RuntimeError, match="no backward"):
            sgmv.sgmv_add_(y, *args, table, 1.0)
        with torch.no_grad():
            sgmv.sgmv_add_(y, *args, table, 1.0)


def test_batched_forward_launches_once_per_projection(card):
    """A batched-ctx forward on the card: one sgmv call and one CUDA launch
    for each adapted projection of each layer, one segment table for the
    whole forward, and the logits of the CPU forward."""
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.models import forward_seq, lm_logits
    cfg = dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"], dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 3, seed=0, device="cpu", b_scale=0.2)
    tokens = torch.randint(0, cfg.vocab_size, (5, 12),
                           generator=torch.Generator().manual_seed(1))
    ids = torch.tensor([2, 0, 1, 2, 2], dtype=torch.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        ctx = batched_ctx(stack_adapters([tree_map(lambda t: t.to(dev), t)
                                          for t in adapters]), ids.to(dev), cfg)
        n, nc = sgmv.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n
        with torch.no_grad():
            h, _, _ = forward_seq(p, tokens.to(dev), cfg, ctx)
            out[dev] = lm_logits(h, p, cfg).cpu()
        want = 6 * cfg.num_layers if dev == "cuda" else 0
        assert (sgmv.LAUNCHES.n - n, sgmv.CUDA_LAUNCHES.n - nc) == (want, want)
        assert len(ctx._tables) == (1 if dev == "cuda" else 0)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


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
    ids = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="rank"):      # rank 12
        sgmv.sgmv(x, torch.zeros(2, 64, 12, device="cuda"),
                  torch.zeros(2, 12, 8, device="cuda"), ids)
    a32, b32 = torch.zeros(2, 64, 4, device="cuda"), torch.zeros(2, 4, 8, device="cuda")
    with pytest.raises(ValueError, match="dtype"):     # y not in the rows' dtype
        sgmv.sgmv_add_(torch.zeros(4, 8, device="cuda", dtype=torch.bfloat16),
                       x, a32, b32, sgmv.sgmv_table(ids, 2), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        sgmv.sgmv_add_(torch.zeros(8, 4, device="cuda").T, x, a32, b32,
                       sgmv.sgmv_table(ids, 2), 1.0)


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
    gqa.LAUNCHES.n = sgmv.LAUNCHES.n = sgmv.CUDA_LAUNCHES.n = 0
    def to_card(tree):
        return tree_map(lambda t: t.to("cuda"), tree)
    res_gpu, st = RolloutEngine(cfg, to_card(params), max_len=48,
                                device="cuda").generate(
        reqs, [to_card(t) for t in adapters])
    assert gqa.LAUNCHES.n == cfg.num_layers * st.decode_steps
    assert sgmv.LAUNCHES.n == 6 * cfg.num_layers * (st.decode_steps + 1)
    assert sgmv.CUDA_LAUNCHES.n == sgmv.LAUNCHES.n
    for a, b in zip(res_cpu, res_gpu):
        assert a["tokens"] == b["tokens"]
        torch.testing.assert_close(torch.tensor(b["gen_logprobs"]),
                                   torch.tensor(a["gen_logprobs"]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["tied", "untied"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype,tol,dh_tol", [(torch.float32, 1e-4, 1e-4),
                                              (torch.bfloat16, 1e-3, 1e-2)])
def test_token_logprob_matches_plain(card, layout, softcap, dtype, tol, dh_tol):
    """Forward and backward kernels against the plain versions, ragged V.
    fp32 and bf16 logits both accumulate in fp32 (sum order only); the bf16
    backward rounds dz to bf16 before dz @ W^T, hence 1e-2 of dh's scale."""
    R, d, V = 100, 96, 1000
    h = torch.randn(R, d, generator=card, device="cuda").to(dtype)
    if layout == "tied":
        w = (torch.randn(V, d, generator=card, device="cuda") * 0.2).to(dtype).T
    else:
        w = (torch.randn(d, V, generator=card, device="cuda") * 0.2).to(dtype)
    t = torch.randint(0, V, (R,), generator=card, device="cuda", dtype=torch.int32)
    lp, ent, lse = tlp.token_logprob_fwd(h, w, t, softcap)
    want_lp, want_ent, want_lse = ref.token_logprob_stats_ref(h, w, t, softcap)
    for got, want in ((lp, want_lp), (ent, want_ent), (lse, want_lse)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    g_lp = torch.randn(R, generator=card, device="cuda")
    g_ent = torch.randn(R, generator=card, device="cuda")
    dh = tlp.token_logprob_bwd(h, w, t, want_lse, want_ent, g_lp, g_ent, softcap)
    want = ref.token_logprob_bwd_ref(h, w, t, want_lse, want_ent, g_lp, g_ent,
                                     softcap)
    assert dh.dtype == dtype
    err = (dh.float() - want.float()).abs().max()
    assert err <= dh_tol * want.float().abs().max(), err


def _bf16_inputs(card, R, d, V, layout):
    """h, W = a [V, d] table's transpose ('tied') or a [d, V] head
    ('untied'), and targets, in bf16 on the card."""
    h = torch.randn(R, d, generator=card, device="cuda").bfloat16()
    if layout == "tied":
        w = (torch.randn(V, d, generator=card, device="cuda") * 0.02).bfloat16().T
    else:
        w = (torch.randn(d, V, generator=card, device="cuda") * 0.02).bfloat16()
    t = torch.randint(0, V, (R,), generator=card, device="cuda", dtype=torch.int32)
    return h, w, t


def _assert_bf16_forward(h, w, t, softcap):
    """Two calls of the bf16 forward kernel against the plain version: lp,
    entropy and lse within 1e-3 absolute (fp32 accumulation on both sides,
    sum order only), the two calls bit-identical, 2 CUDA launches a call
    (the kernel and the merge)."""
    n0 = tlp.FWD_CUDA_LAUNCHES.n
    got = tlp.token_logprob_fwd(h, w, t, softcap)
    assert tlp.FWD_CUDA_LAUNCHES.n - n0 == 2
    again = tlp.token_logprob_fwd(h, w, t, softcap)
    want = ref.token_logprob_stats_ref(h, w, t, softcap)
    for a, b, c in zip(got, again, want):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-3)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    return want


def _bf16_forward_backward(card, R, d, V, layout, softcap):
    """The forward checked (``_assert_bf16_forward``), then two calls of the
    bf16 backward kernel and the plain backward on the plain forward's
    statistics."""
    h, w, t = _bf16_inputs(card, R, d, V, layout)
    g_lp = torch.randn(R, generator=card, device="cuda") / R
    g_ent = torch.randn(R, generator=card, device="cuda") / R
    _, ent, lse = _assert_bf16_forward(h, w, t, softcap)
    dh = tlp.token_logprob_bwd(h, w, t, lse, ent, g_lp, g_ent, softcap)
    again = tlp.token_logprob_bwd(h, w, t, lse, ent, g_lp, g_ent, softcap)
    want = ref.token_logprob_bwd_ref(h, w, t, lse, ent, g_lp, g_ent, softcap)
    return dh, again, want


def _assert_bf16_dh(dh, again, want):
    assert dh.dtype == torch.bfloat16
    err = (dh.float() - want.float()).abs().max()
    assert err <= 1e-2 * want.float().abs().max(), err
    assert torch.equal(dh.view(torch.int16), again.view(torch.int16))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("layout", ["tied", "untied"])
@pytest.mark.parametrize("V", [5003, 100])
@pytest.mark.parametrize("R", [1, 127, 300])
def test_token_logprob_bf16_backward_matches_plain(card, R, V, layout, softcap):
    """The bf16 forward (the logits product with an online-softmax
    epilogue) and backward (two tiled tensor-core products per vocab chunk)
    at d = 1024 against the plain versions: ragged R, V = 5003 (with an
    untied head its odd row stride takes the unvectorised loads) and V = 100
    (less than one 128-column tile). lp, entropy and lse within 1e-3; dh
    within 1e-2 of its largest element (dz rounds to bf16 before dz @ W^T);
    two calls of each give the same bits."""
    _assert_bf16_dh(*_bf16_forward_backward(card, R, 1024, V, layout, softcap))


def test_token_logprob_bf16_backward_at_qwen3_width(card):
    """qwen3-0.6b's training shape: 624 rows, V = 151936 (one wave of
    forward blocks; two vocab chunks of the backward's plan), the tied
    embedding's transpose as W; forward and backward."""
    _assert_bf16_dh(*_bf16_forward_backward(card, 624, 1024, 151936, "tied", 0.0))


@pytest.mark.parametrize("layout", ["tied", "untied"])
@pytest.mark.parametrize("V", [5003, 100])
def test_token_logprob_bf16_forward_targets_at_the_edges(card, V, layout):
    """Targets on the vocabulary's first and last columns (V - 1 lies in
    the ragged last tile, beside the zero-filled columns the epilogue
    leaves out)."""
    h, w, _ = _bf16_inputs(card, 127, 1024, V, layout)
    t = torch.tensor([0, V - 1] * 63 + [V - 1], dtype=torch.int32, device="cuda")
    for softcap in (0.0, 30.0):
        _assert_bf16_forward(h, w, t, softcap)


@pytest.mark.parametrize("major", ["k", "v"])
def test_token_logprob_bf16_forward_takes_any_strides(card, major):
    """A W with neither stride 1 (a strided view of a larger table) takes
    the forward's unvectorised loads; 'k': W's k stride is the smaller
    (staged k-major), 'v': its v stride."""
    R, d, V = 127, 1024, 5003
    h = torch.randn(R, d, generator=card, device="cuda").bfloat16()
    if major == "k":
        big = torch.randn(3 * V, 2 * d, generator=card, device="cuda") * 0.02
        w = big.bfloat16()[::3, ::2].T
    else:
        big = torch.randn(2 * d, 3 * V, generator=card, device="cuda") * 0.02
        w = big.bfloat16()[::2, ::3]
    assert w.shape == (d, V) and 1 not in w.stride()
    t = torch.randint(0, V, (R,), generator=card, device="cuda", dtype=torch.int32)
    _assert_bf16_forward(h, w, t, 0.0)


def test_token_logprob_bf16_backward_scratch_at_production_rows(card):
    """At a production micro-batch (4096 rows, qwen3-0.6b widths) the
    backward allocates dh and its plan's scratch, and that scratch (the
    [R, vc] dz chunk and the fp32 partials) stays under 128 MiB: no [R, V]
    buffer. The C launcher reports two products per vocab chunk and a
    reduce."""
    R, d, V = 4096, 1024, 151936
    plan = tlp.backward_plan(R, d, V)
    assert plan.scratch_bytes <= tlp.SCRATCH_LIMIT == 128 << 20
    h = torch.randn(R, d, generator=card, device="cuda").bfloat16()
    w = (torch.randn(V, d, generator=card, device="cuda") * 0.02).bfloat16().T
    t = torch.randint(0, V, (R,), generator=card, device="cuda", dtype=torch.int32)
    stats = [torch.zeros(R, device="cuda") for _ in range(4)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    n0 = tlp.BWD_CUDA_LAUNCHES.n
    dh = tlp.token_logprob_bwd(h, w, t, *stats)
    launched = tlp.BWD_CUDA_LAUNCHES.n - n0
    torch.cuda.synchronize()
    used = torch.cuda.max_memory_allocated() - base
    assert used <= plan.scratch_bytes + dh.numel() * 2 + (1 << 20), used
    # two products per vocab chunk, then the reduce
    assert launched == 2 * -(-V // plan.vc) + 1, (launched, plan)


def test_token_logprob_refuses_what_the_kernels_do_not_take(card):
    h = torch.zeros(4, 32, device="cuda", requires_grad=True)
    w = torch.zeros(32, 70, device="cuda")
    t = torch.zeros(4, dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="dW"):
        tlp.token_logprob_flat(h, w.requires_grad_(True), t)
    with pytest.raises(ValueError, match="int32"):
        tlp.token_logprob_fwd(h.detach(), w.detach(), t.long())
    with pytest.raises(ValueError, match="outside"):
        tlp.token_logprob_fwd(h.detach(), w.detach(), t + 70)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tlp.token_logprob_fwd(h.detach().half(), w.detach().half(), t)
    strided = torch.zeros(64, 140, device="cuda", dtype=torch.bfloat16)[::2, ::2]
    stats = torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tlp.token_logprob_bwd(h.detach().bfloat16(), strided, t, stats, stats,
                              stats, stats)


def test_train_step_on_card_matches_cpu(card):
    """qwen3-0.6b reduced (hd=16) in fp32: generate, pack, and one GRPO step
    with the KL and entropy terms, on the card (token_logprob kernels: two
    forwards and one backward) and on the CPU (plain versions), from the
    same weights and batch. Loss and metrics at 1e-4; updated adapters at
    1e-6 where the gradient is above 100 eps."""
    cfg = dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"], dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lora = make_adapters(cfg, 1, seed=0, device="cpu", b_scale=0.2)[0]
    reqs = make_requests(1, 4, max_new_tokens=8)
    res, _ = RolloutEngine(cfg, params, max_len=48, device="cpu").generate(
        reqs, [lora])
    tb = to_trajectory_batch(res, "tenant-0", 0, group_size=2)
    tc = TrainConfig(group_size=2, kl_coef=0.01, ent_coef=0.01,
                     use_logprob_kernel=True, adamw=AdamWConfig(lr=3e-3))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        a = tree_map(lambda x: x.to(dev), lora)
        tlp.FWD_LAUNCHES.n = tlp.BWD_LAUNCHES.n = 0
        out[dev] = make_train_step(cfg, tc)(p, a, init_opt_state(cfg, tc, p, a),
                                            batch_from_trajectory(tb, tc, dev))
        counts = (tlp.FWD_LAUNCHES.n, tlp.BWD_LAUNCHES.n)
        assert counts == ((0, 0) if dev == "cpu" else (2, 1)), counts
    (new_c, opt_c, m_c), (new_g, _, m_g) = out["cpu"], out["cuda"]
    for k in m_c:
        torch.testing.assert_close(m_g[k].cpu(), m_c[k], rtol=1e-4, atol=1e-4)
    for pc, pg, mc in zip(tree_leaves(new_c), tree_leaves(new_g),
                          tree_leaves(opt_c["m"])):
        sure = (10 * mc).abs() > 1e-6
        assert sure.float().mean() > 0.5
        assert (pg.cpu() - pc).abs()[sure].max() <= 1e-6


def _paged_inputs(card, B, H, KVH, hd, n_pg, page, dtype):
    """A pool of 2*B*n_pg pages (+ scratch) handed out as a random
    permutation; rows past ceil(pos/page) keep sentinel entries."""
    P = 2 * B * n_pg
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    kp = torch.randn(P + 1, page, KVH, hd, generator=card, device="cuda").to(dtype)
    vp = torch.randn(P + 1, page, KVH, hd, generator=card, device="cuda").to(dtype)
    perm = torch.randperm(P, generator=card, device="cuda")[:B * n_pg]
    tbl = perm.reshape(B, n_pg).to(torch.int32)
    pos = torch.randint(1, n_pg * page + 1, (B,), generator=card, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[-1] = 1, n_pg * page
    live = (pos.long() + page - 1) // page
    tbl[torch.arange(n_pg, device="cuda")[None, :] >= live[:, None]] = P
    return q, kp, vp, tbl, pos


@pytest.mark.parametrize("hd,page", [(16, 8), (64, 16), (128, 16), (128, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_paged_gqa_decode_matches_plain(card, hd, page, dtype, tol):
    q, kp, vp, tbl, pos = _paged_inputs(card, 5, 16, 8, hd, 7, page, dtype)
    for cap, win in ((0.0, 0), (50.0, 0), (0.0, 24)):
        got = paged.paged_gqa_decode(q, kp, vp, tbl, pos, softcap=cap, window=win)
        want = ref.paged_gqa_decode_ref(q, kp, vp, tbl, pos, softcap=cap,
                                        window=win)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_paged_gqa_decode_identity_table_equals_gqa_decode(card):
    """Pages laid out in row order through an identity table: the paged
    kernel reads the same values as the contiguous kernel."""
    B, H, KVH, hd, n_pg, page = 3, 16, 8, 128, 6, 16
    ck = torch.randn(B, n_pg * page, KVH, hd, generator=card, device="cuda")
    cv = torch.randn(B, n_pg * page, KVH, hd, generator=card, device="cuda")
    q = torch.randn(B, H, hd, generator=card, device="cuda")
    pos = torch.tensor([5, 40, 96], dtype=torch.int32, device="cuda")
    zero = torch.zeros(1, page, KVH, hd, device="cuda")
    kp = torch.cat([ck.reshape(B * n_pg, page, KVH, hd), zero])
    vp = torch.cat([cv.reshape(B * n_pg, page, KVH, hd), zero])
    tbl = torch.arange(B * n_pg, dtype=torch.int32, device="cuda").reshape(B, n_pg)
    torch.testing.assert_close(paged.paged_gqa_decode(q, kp, vp, tbl, pos),
                               gqa.gqa_decode(q, ck, cv, pos), rtol=2e-5,
                               atol=2e-5)


def _split_case(card, B, H, KVH, hd, cap, page, dtype, pos):
    """One set of values as a contiguous cache and as a shuffled pool with
    sentinel entries past each row's live pages: (q, ck, cv, kp, vp, tbl,
    pos)."""
    n_pg = cap // page
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    ck = torch.randn(B, cap, KVH, hd, generator=card, device="cuda").to(dtype)
    cv = torch.randn(B, cap, KVH, hd, generator=card, device="cuda").to(dtype)
    P = B * n_pg
    perm = torch.randperm(P, generator=card, device="cuda")
    kp = torch.empty(P + 1, page, KVH, hd, device="cuda", dtype=dtype)
    vp = torch.empty_like(kp)
    kp[perm] = ck.reshape(P, page, KVH, hd)
    vp[perm] = cv.reshape(P, page, KVH, hd)
    kp[P], vp[P] = 7.0, -7.0                      # the scratch page
    tbl = perm.reshape(B, n_pg).to(torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    live = (pos.long() + page - 1) // page
    tbl[torch.arange(n_pg, device="cuda")[None, :] >= live[:, None]] = P
    return q, ck, cv, kp, vp, tbl, pos


def _both_kernels(case, cap, win):
    q, ck, cv, kp, vp, tbl, pos = case
    return {"gqa": (gqa.gqa_decode(q, ck, cv, pos, softcap=cap, window=win),
                    ref.gqa_decode_ref(q, ck, cv, pos, softcap=cap, window=win)),
            "paged": (paged.paged_gqa_decode(q, kp, vp, tbl, pos, softcap=cap,
                                             window=win),
                      ref.paged_gqa_decode_ref(q, kp, vp, tbl, pos,
                                               softcap=cap, window=win))}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_split_decode_at_the_chunk_edges(card, dtype, tol):
    """Both kernels at qwen3's widths over a 2048-key cache (page 16): rows
    at pos 1, chunk-1, chunk, chunk+1 and the capacity; softcap 50;
    windows of 24 (one chunk a row, the rest of the grid empty), 200 (two
    chunks, across an edge) and 5 (smaller than a page). Two calls give the
    same bits."""
    B, H, KVH, hd, cap, page = 6, 16, 8, 128, 2048, 16
    c = gqa.decode_plan(B, KVH, cap, page, H=H, hd=hd).chunk
    assert c == gqa.decode_plan(B, KVH, cap, 1, H=H, hd=hd).chunk
    case = _split_case(card, B, H, KVH, hd, cap, page, dtype,
                       [1, c - 1, c, c + 1, 3 * c + 5, cap])
    for softcap, win in ((0.0, 0), (50.0, 0), (0.0, 24), (0.0, 200), (0.0, 5)):
        first = _both_kernels(case, softcap, win)
        again = _both_kernels(case, softcap, win)
        for name, (got, want) in first.items():
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol, msg=f"{name} {softcap} {win}")
            assert torch.equal(got, again[name][0]), name


@pytest.mark.parametrize("kernel", ["gqa", "paged"])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_split_decode_every_variant(card, kernel, rep, hd, dtype, tol):
    """Every (hd, rep) the wrappers take, in both dtypes, at a cache of
    2048 keys split over blocks, against the plain versions."""
    B, KVH, cap, page = 3, 2, 2048, 16
    case = _split_case(card, B, KVH * rep, KVH, hd, cap, page, dtype,
                       [cap, 1000, 77])
    got, want = _both_kernels(case, 0.0, 0)[kernel]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_graph_replay_gives_eager_bits(card, dtype):
    """Both kernels captured in a CUDA graph: two replays give the eager
    call's bits (the merge tickets are back at 0 after every launch)."""
    B, H, KVH, hd, cap, page = 4, 16, 8, 128, 2048, 16
    q, ck, cv, kp, vp, tbl, pos = _split_case(card, B, H, KVH, hd, cap, page,
                                              dtype, [2048, 1500, 300, 40])
    eager = (gqa.gqa_decode(q, ck, cv, pos),
             paged.paged_gqa_decode(q, kp, vp, tbl, pos))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (gqa.gqa_decode(q, ck, cv, pos),
                paged.paged_gqa_decode(q, kp, vp, tbl, pos))
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.zeros(2, 4, 32, device="cuda")
    pool = torch.zeros(5, 8, 2, 32, device="cuda")
    tbl = torch.zeros(2, 3, dtype=torch.int32, device="cuda")
    pos = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        paged.paged_gqa_decode(q, pool, pool, tbl.long(), pos)
    with pytest.raises(ValueError, match="head_dim"):
        paged.paged_gqa_decode(torch.zeros(2, 4, 48, device="cuda"),
                               torch.zeros(5, 8, 2, 48, device="cuda"),
                               torch.zeros(5, 8, 2, 48, device="cuda"), tbl, pos)
    with pytest.raises(ValueError, match="dtypes"):
        paged.paged_gqa_decode(q.half(), pool.half(), pool.half(), tbl, pos)
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_gqa_decode(q, pool, pool, tbl.t().contiguous().t(), pos)


def test_continuous_paged_on_card_matches_cpu(card):
    """qwen3-0.6b reduced (hd=16) in fp32 through the paged continuous
    engine (4 slots, a pool of 12 pages of 8 tokens, tenant-0 preempted
    mid-run and restored from its host snapshot): the card (kernels) and
    the CPU (plain versions) give the same tokens, page invariants hold
    after every step, and the paged kernel launches once per layer per
    decode step."""
    cfg = dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"], dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 2, seed=0, device="cpu", b_scale=0.2)
    reqs = make_requests(2, 4, max_new_tokens=10)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ContinuousRolloutEngine(
            cfg, tree_map(lambda t: t.to(dev), params), max_slots=4,
            max_adapters=2, max_len=64, paged_kv=True, prefix_cache=False,
            kv_page_size=8, kv_pool_pages=12, device=dev)
        for i, a in enumerate(adapters):
            eng.set_adapters(i, tree_map(lambda t: t.to(dev), a))
        pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
        paged.LAUNCHES.n = gqa.LAUNCHES.n = 0
        comps, it = {}, 0
        while not eng.idle() and it < 200:
            eng.step()
            it += 1
            eng.check_page_invariants()
            if it == 3:
                eng.preempt_tenant("tenant-0")
            for c in eng.drain_completions():
                comps[pos_of[c.submit_index]] = c
        assert len(comps) == len(reqs)
        st = eng.stats
        assert st.preemptions > 0 and st.restores > 0 and st.replays == 0
        want = cfg.num_layers * st.decode_steps if dev == "cuda" else 0
        assert (paged.LAUNCHES.n, gqa.LAUNCHES.n) == (want, 0)
        out[dev] = comps
    for i in range(len(reqs)):
        a, b = out["cpu"][i], out["cuda"][i]
        assert a.tokens == b.tokens
        torch.testing.assert_close(torch.tensor(b.gen_logprobs),
                                   torch.tensor(a.gen_logprobs), rtol=1e-4,
                                   atol=1e-4)


# -- the prefix cache: COW forks, radix installs, page accounting ----------

def _qwen3_reduced():
    return dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"], dtype="float32"),
                               vocab_size=tok.VOCAB_SIZE)


def test_cow_fork_then_paged_decode_write(card):
    """Two rows share pages [p0, p1] (p1 their partial tail); the engine's
    COW function copies p1 to p2 and row 1's table is switched to it, then
    one decode step writes each row's token into its own tail page through
    the paged kernel: p2 holds p1's old entries and row 1's new one, p1 row
    0's, and each row's logits equal the CPU's (plain versions) on the same
    pool."""
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.models import decode_step, init_paged_cache
    from repro_torch.rollout.engine import _build_cow_fn
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 2, seed=0, device="cpu", b_scale=0.2)
    page, pos = 8, 11
    out = {}
    for dev in ("cpu", "cuda"):
        cache = init_paged_cache(cfg, 2, pool_pages=4, page_size=page,
                                 max_pages_per_row=4, dtype=torch.float32,
                                 device=dev)
        g = torch.Generator().manual_seed(3)
        for key in ("kp", "vp"):
            cache[key].copy_(torch.randn(cache[key].shape, generator=g))
        cache["tbl"].copy_(torch.tensor([[0, 1, 4, 4], [0, 1, 4, 4]]))
        cache["pos"].fill_(pos)
        old, p0 = cache["kp"][:, 1].cpu(), cache["kp"][:, 0].cpu()
        cache = _build_cow_fn(cfg)(cache, 1, 2)
        cache["tbl"][1, 1] = 2
        lora = batched_ctx(stack_adapters([tree_map(lambda t: t.to(dev), a)
                                           for a in adapters]),
                           torch.tensor([0, 1], device=dev), cfg)
        paged.LAUNCHES.n = 0
        with torch.inference_mode():
            logits, cache = decode_step(tree_map(lambda t: t.to(dev), params),
                                        torch.tensor([5, 9], device=dev),
                                        cache, cfg, lora)
        assert paged.LAUNCHES.n == (cfg.num_layers if dev == "cuda" else 0)
        kp = cache["kp"].cpu()
        off = pos % page
        assert torch.equal(kp[:, 2, :off], old[:, :off])
        assert torch.equal(kp[:, 1, :off], old[:, :off])
        assert torch.equal(kp[:, 1, off + 1:], old[:, off + 1:])
        assert not torch.equal(kp[:, 1, off], kp[:, 2, off])
        assert torch.equal(kp[:, 0], p0)
        out[dev] = (logits.cpu(), kp)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-5)


def test_radix_suffix_install_on_card_matches_plain(card):
    """A radix hit in bf16 at qwen3-0.6b's width (2 layers): 48 prompt
    tokens prefilled into pool pages, then a row whose first 32 tokens match
    installs through the engine's suffix function (the matched pages
    gathered, the 17-token suffix through forward_prefill_chunk with the
    sgmv kernel, 6 launches a layer). Its first-token logprob (the token
    forced, so that both devices score the same one) and the K/V written to
    its fresh pages equal the CPU's (plain versions) within the decode
    tests' bf16 tolerance."""
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.models import forward_seq, init_cache, init_paged_cache
    from repro_torch.rollout.engine import _build_suffix_fn
    from repro_torch.rollout.prefill import _bucket_len
    cfg = dataclasses.replace(REGISTRY["qwen3-0.6b"], num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 2, seed=0, device="cpu", b_scale=0.02)
    page, start, L = 16, 32, 49
    g = torch.Generator().manual_seed(4)
    seq = torch.randint(3, 1000, (L,), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        stacked = stack_adapters([tree_map(lambda t: t.to(dev), a)
                                  for a in adapters])
        cache = init_paged_cache(cfg, 2, pool_pages=8, page_size=page,
                                 max_pages_per_row=4, device=dev)
        with torch.inference_mode():
            pre = init_cache(cfg, 1, start, device=dev)
            _, pre, _ = forward_seq(p, seq[None, :start].to(dev), cfg,
                                    batched_ctx(stacked, torch.tensor(
                                        [1], device=dev), cfg), pre)
            for j in range(start // page):
                cache["kp"][:, 5 + j] = pre["k"][:, 0, j * page:(j + 1) * page]
                cache["vp"][:, 5 + j] = pre["v"][:, 0, j * page:(j + 1) * page]
            toks = torch.zeros((1, _bucket_len(L - start)), dtype=torch.int32)
            toks[0, :L - start] = seq[start:]
            state = [torch.zeros((2,), dtype=torch.int32, device=dev),
                     torch.zeros((2,), dtype=torch.int32, device=dev),
                     torch.zeros((2, 2), dtype=torch.int64, device=dev),
                     torch.ones((2,), dtype=torch.float32, device=dev),
                     torch.zeros((2,), dtype=torch.int32, device=dev)]
            sgmv.CUDA_LAUNCHES.n = 0

            def t(v, dt):
                return torch.tensor(v, dtype=dt, device=dev)
            first, lp, cache, _ = _build_suffix_fn(cfg, page)(
                start, p, stacked, t([1], torch.int32), t([5, 6], torch.int64),
                toks.to(dev), L, t([0], torch.int32),
                t([[0, 7]], torch.int64), t([1.0], torch.float32),
                t([123], torch.int32), t([1], torch.int32), cache,
                t([0, 1], torch.int64), 2, 1, *state)
        assert sgmv.CUDA_LAUNCHES.n == (6 * cfg.num_layers if dev == "cuda"
                                        else 0)
        assert int(cache["pos"][1]) == L and int(first[0]) == 123
        out[dev] = (lp.float().cpu(), cache["kp"][:, :2].float().cpu(),
                    cache["vp"][:, :2].float().cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2)


def test_prefix_cache_page_invariants_on_card(card):
    """qwen3-0.6b reduced in fp32, a GRPO group of 4 and a second prompt
    behind a shared 24-token header, 3 slots, pages of 8, the group
    preempted at step 4: page invariants after every step on the card; the
    card's tokens, prefix counters and paged launches equal the CPU's (plain
    versions); forks, hits and device-resident resumes happen, and at idle
    the pool holds only the index's pages."""
    from repro_torch.launch.serve import make_group_requests
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 1, seed=0, device="cpu", b_scale=0.2)
    reqs = make_group_requests(1, 2, 3, header_len=24, max_new_tokens=10,
                               seed=5)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = ContinuousRolloutEngine(
            cfg, tree_map(lambda t: t.to(dev), params), max_slots=3,
            max_adapters=1, max_len=64, paged_kv=True, kv_page_size=8,
            device=dev)
        eng.set_adapters(0, tree_map(lambda t: t.to(dev), adapters[0]))
        pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
        paged.LAUNCHES.n = 0
        comps, it = {}, 0
        while not eng.idle() and it < 200:
            eng.step()
            it += 1
            if it == 4:
                eng.preempt_tenant("tenant-0")
            eng.check_page_invariants()
            for c in eng.drain_completions():
                comps[pos_of[c.submit_index]] = c
        assert len(comps) == len(reqs)
        st = eng.stats
        assert st.prefix_hits > 0 and st.cow_forks > 0
        assert st.device_resident_resumes > 0 and st.snapshots == 0
        assert eng._pages.used_pages == eng._prefix_idx.held_pages
        assert paged.LAUNCHES.n == (cfg.num_layers * st.decode_steps
                                    if dev == "cuda" else 0)
        out[dev] = (comps, (st.prefix_hits, st.prefix_hit_tokens,
                            st.cow_forks, st.device_resident_resumes,
                            st.decode_steps))
    assert out["cuda"][1] == out["cpu"][1]
    for i in range(len(reqs)):
        a, b = out["cpu"][0][i], out["cuda"][0][i]
        assert a.tokens == b.tokens
        torch.testing.assert_close(torch.tensor(b.gen_logprobs),
                                   torch.tensor(a.gen_logprobs), rtol=1e-4,
                                   atol=1e-4)


# -- the runtime: rollout and trainer threads on one card -------------------

def _graded(env):
    """`env` with a graded verifier (the share of even token ids), so that
    rewards differ within a group and the updates are not zero."""
    class Graded(type(env)):
        def verify(self, truth, completion_ids):
            ids = list(completion_ids)
            return sum(t % 2 == 0 for t in ids) / max(1, len(ids))
    return Graded()


def _card_runtime(policy, **kw):
    """qwen3-0.6b at full width and 2 layers in bf16, 2 tenants with
    random-b adapters and graded verifiers, 2 steps each."""
    from repro_torch.core.manager import TaskSpec
    from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
    cfg = dataclasses.replace(REGISTRY["qwen3-0.6b"], num_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    rt = MARLaaSRuntime(cfg, params, RuntimeConfig(
        policy=policy, device="cuda", max_slots=8, max_adapter_slots=2,
        max_len=128, seed=0, **kw))
    adapters = make_adapters(cfg, 2, seed=1, device="cuda", b_scale=0.02)
    for i, env in enumerate(("gsm8k", "amc12")):
        tid = f"{env}-{i}"
        rt.submit_task(TaskSpec(tid, env, group_size=4, num_groups=1,
                                max_new_tokens=16, target_steps=2),
                       adapters[i])
        rt.envs[tid] = _graded(rt.envs[tid])
    return cfg, rt


def _check_installs(rt):
    """Wrap the manager's commit and the engine's set_adapters: every
    install must be a tree the manager committed (or a tenant's first) and
    equal the stacked slot the decode reads. Returns the trees installed
    that a commit made, and the grad norms of the commits."""
    from repro_torch.models import tree_leaves
    eng, commit, set_adapters = rt.cengine, rt.mgr.commit, rt.cengine.set_adapters
    first = [st.adapters for _, st in rt.mgr.task_items()]
    committed, trained, norms = list(first), [], []
    spec = next(st.spec for _, st in rt.mgr.task_items())
    step = rt._train_step_for(spec)

    def kept_step(*a):
        out = step(*a)
        norms.append(float(out[2]["grad_norm"]))
        return out

    def listed_commit(tid, tree, *a, **kw):
        committed.append(tree)
        return commit(tid, tree, *a, **kw)

    def checked_install(slot, tree):
        set_adapters(slot, tree)
        assert any(tree is t for t in committed)
        assert all(torch.equal(buf[:, slot], leaf) for buf, leaf in
                   zip(tree_leaves(eng._stacked), tree_leaves(tree)))
        if not any(tree is t for t in first):
            trained.append(tree)
    rt._train_steps[spec.group_size] = kept_step
    rt.mgr.commit, eng.set_adapters = listed_commit, checked_install
    return trained, norms


@pytest.mark.parametrize("run", ["A", "B"])
def test_runtime_on_card_invariants_and_launches(card, run):
    """Run A (the defaults: dense cache, round-synchronous trainer) and run
    B (async trainer at max_staleness 1 over the paged pool): every tenant
    at its target version, an exact row account, serialised train
    intervals; decode attention 2 launches a decode step (the paged kernel
    in B, gqa_decode in A), sgmv 12 a forward, token_logprob one forward
    and one backward a commit; every commit's gradient is nonzero, and
    the committed trees reach the engine's stacked buffer."""
    kw = {} if run == "A" else dict(async_train=True, max_staleness=1,
                                    min_train_rows=4, paged_kv=True,
                                    prefix_cache=False, kv_page_size=16)
    cfg, rt = _card_runtime("marlaas", **kw)
    eng = rt.cengine
    eng._ensure_built()
    refill, forwards = eng._refill_fn, [0]

    def counted(*a):
        forwards[0] += 1
        return refill(*a)
    eng._refill_fn = counted
    trained, norms = _check_installs(rt)
    counters = [gqa.LAUNCHES, paged.LAUNCHES, sgmv.LAUNCHES,
                tlp.FWD_LAUNCHES, tlp.BWD_LAUNCHES]
    for c in counters:
        c.n = 0
    rt.run(timeout_s=300)
    got = [c.n for c in counters]
    assert rt.mgr.all_done()
    assert all(st.version == 2 for _, st in rt.mgr.task_items())
    acc = rt.row_accounting()
    assert acc["orphaned"] == acc["failed"] == 0
    assert acc["completed"] == (acc["trained"] + acc["stale_dropped"]
                                + acc["discarded_tails"])
    trains = sorted((iv for iv in rt.rec.intervals if iv.phase == "train"),
                    key=lambda iv: iv.start)
    assert len(trains) == 4
    assert all(b.start >= a.end - 1e-6 for a, b in zip(trains, trains[1:]))
    assert len(norms) == 4 and all(n > 0 for n in norms), norms
    if run == "A":     # each tenant's version 1 (B may train 2 off v0)
        assert len(trained) == 2
    steps = eng.stats.decode_steps
    attn = [2 * steps, 0] if run == "A" else [0, 2 * steps]
    assert got == attn + [12 * (steps + forwards[0]), 4, 4]
    if run == "A":
        assert acc["trained"] == acc["completed"] == 16
    else:
        assert eng._pages.used_pages == 0


@pytest.mark.parametrize("policy", ["multilora_sync", "single_disagg"])
def test_runtime_sync_policies_train_after_generate_on_card(card, policy):
    """generate() serves under inference_mode and the train step runs next
    on the same thread: no tensor the step saves for backward may come from
    the served round."""
    _, rt = _card_runtime(policy)
    tlp.BWD_LAUNCHES.n = 0
    rt.run(timeout_s=300)
    assert rt.mgr.all_done() and tlp.BWD_LAUNCHES.n == 4
    assert all(st.version == 2 for _, st in rt.mgr.task_items())


# -- the disaggregated prefill stage: streams, copy-on-write, counts -------

def _stage_engine(cfg, params, adapters, **kw):
    eng = ContinuousRolloutEngine(cfg, params, max_slots=2, max_adapters=2,
                                  max_len=64, disagg_prefill=True,
                                  device="cuda", **kw)
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    eng._ensure_built()
    return eng


def test_worker_stream_splice_equals_one_stream(card):
    """A row prefilled by a worker on its own stream (event recorded after
    its last kernel, the decode stream waiting on it before the copy) and
    spliced into the paged pool leaves the same pool bytes, first token and
    logprob as the same row prefilled on the decode stream itself, on
    qwen3-0.6b reduced in fp32."""
    from repro_torch.rollout.prefill import PrefillWorker, _Job
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    adapters = make_adapters(cfg, 2, seed=0, device="cuda", b_scale=0.2)
    req = make_requests(1, 1, max_new_tokens=4, seed=5)[0]
    out = []
    for own_stream in (True, False):
        eng = _stage_engine(cfg, params, adapters, paged_kv=True,
                            prefix_cache=False, kv_page_size=8)
        eng.submit(req)
        w = PrefillWorker(eng, 0)
        if not own_stream:
            w.stream = torch.cuda.current_stream()
        assert (w.stream != torch.cuda.current_stream()) == own_stream
        row = w._try_pop()
        assert row is not None
        torch.cuda.synchronize()
        with torch.no_grad(), torch.cuda.stream(w.stream):
            assert w._advance(_Job(row))
        rr = eng._ready[0]
        assert rr.event is not None
        first, lp = rr.first, rr.lp
        with torch.no_grad():
            assert eng._splice_ready_rows()
        slot = next(s for s, r in enumerate(eng._rows) if r is row)
        pages = torch.tensor(eng._slot_pages[slot], device="cuda")
        torch.cuda.synchronize()
        out.append((first, lp, eng._cache["kp"][:, pages].cpu(),
                    eng._cache["vp"][:, pages].cpu(),
                    int(eng._cache["pos"][slot])))
        eng.check_page_invariants()
        eng.shutdown()
    (f1, l1, k1, v1, p1), (f2, l2, k2, v2, p2) = out
    assert (f1, p1) == (f2, p2) and l1 == l2
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_set_adapters_copy_on_write_under_inflight_worker(card):
    """A worker is held inside its prefill call of a row on adapter slot 0
    (before its kernels) while the decode thread installs another tree at
    slot 0: the call keeps the old buffer, so the row's first token and
    logprob equal those of a run with no install; the new tree reaches the
    stacked buffer the decode thread reads."""
    import threading
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    adapters = make_adapters(cfg, 3, seed=0, device="cuda", b_scale=0.2)
    req = make_requests(1, 1, max_new_tokens=3, seed=6)[0]
    firsts = []
    for install in (False, True):
        eng = _stage_engine(cfg, params, adapters[:2])
        whole, entered, go = eng._pkernels.whole, threading.Event(), \
            threading.Event()

        def held(*a, whole=whole, entered=entered, go=go, **kw):
            entered.set()
            assert go.wait(60)
            return whole(*a, **kw)
        eng._pkernels.whole = held
        eng.submit(req)
        while not entered.is_set():
            eng.step()
        old = eng._stacked
        if install:
            eng.set_adapters(0, adapters[2])
            assert eng._stacked is not old
            assert all(torch.equal(buf[:, 0], leaf) for buf, leaf in zip(
                tree_leaves(eng._stacked), tree_leaves(adapters[2])))
            assert all(torch.equal(buf[:, 0], leaf) for buf, leaf in zip(
                tree_leaves(old), tree_leaves(adapters[0])))
        go.set()
        comps = eng.drain(deadline_s=120.0)
        assert len(comps) == 1
        firsts.append((comps[0].tokens[comps[0].prompt_len],
                       comps[0].gen_logprobs[0]))
        eng.shutdown()
    assert firsts[0] == firsts[1]


def test_launch_counts_exact_with_two_threads(card):
    """Two threads launch sgmv at once, each on its own stream, 400 times:
    the wrapper's counts (calls and CUDA launches) rise by exactly 800."""
    import threading
    x = torch.randn(16, 1024, device="cuda")
    a = torch.randn(4, 1024, 16, device="cuda") / 32
    b = torch.randn(4, 16, 1024, device="cuda") * 0.1
    ids = torch.tensor([0, 1, 2, 3] * 4, dtype=torch.int32, device="cuda")
    sgmv.sgmv(x, a, b, ids)                 # builds before the threads run
    n0, c0 = sgmv.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n
    start = threading.Barrier(2)

    def launch():
        with torch.no_grad(), torch.cuda.stream(torch.cuda.Stream()):
            start.wait()
            for _ in range(400):
                sgmv.sgmv(x, a, b, ids)
            torch.cuda.current_stream().synchronize()
    threads = [threading.Thread(target=launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert (sgmv.LAUNCHES.n - n0, sgmv.CUDA_LAUNCHES.n - c0) == (800, 800)


def test_kernels_build_once_under_two_threads(card):
    """The first launch may come from a prefill worker while the decode
    thread launches too: two threads asking a fresh builder for the sgmv
    library at once run one build and get the same library."""
    import threading
    from repro_torch.kernels import _build
    builder, calls = _build._Builder(), []
    build_all = builder._build_all

    def counted():
        calls.append(threading.get_ident())
        build_all()
    builder._build_all = counted
    libs, start = [], threading.Barrier(2)

    def first_launch():
        start.wait()
        libs.append(builder.library("sgmv"))
    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert len(calls) == 1 and len(libs) == 2 and libs[0] is libs[1]


# -- tracing, chaos and checkpoints on the card -----------------------------

def test_checkpoint_roundtrip_of_card_trees_is_bit_equal(card, tmp_path):
    """A manager holding fp32 adapter and AdamW trees on the card: the
    store copies them to host (the int32 step too) and the loaded numpy
    trees, put back on the card, are bit-equal to the originals."""
    from repro_torch.bridge import lora_from_jax
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.manager import MultiTaskManager, TaskSpec
    from repro_torch.train.optimizer import adamw_init
    cfg = _qwen3_reduced()
    ad = make_adapters(cfg, 1, seed=3, device="cuda", b_scale=0.2)[0]
    opt = adamw_init(ad)
    opt = {"m": tree_map(lambda t: torch.randn_like(t), opt["m"]),
           "v": tree_map(lambda t: torch.rand_like(t), opt["v"]),
           "step": torch.tensor(7, dtype=torch.int32, device="cuda")}
    m = MultiTaskManager()
    m.submit(TaskSpec("t", "gsm8k"), ad, opt)
    path = save_checkpoint(str(tmp_path), m, step_tag="s")
    st = load_checkpoint(path, MultiTaskManager()).state("t")
    for want, got in ((ad, st.adapters), (opt, st.opt_state)):
        back = lora_from_jax(got, "cuda")
        wl, gl = tree_leaves(want), tree_leaves(back)
        assert len(wl) == len(gl) > 0
        for a, b in zip(wl, gl):
            assert b.device.type == "cuda" and a.dtype == b.dtype
            assert torch.equal(a, b)


def test_chaos_killed_worker_reprefill_gives_unkilled_pool_bytes(card):
    """A worker runs the first 8-token chunk of a row on its own stream
    (behind a spin kernel, so the chunk is still in flight) and dies by
    chaos, stranding the row; the recovery orders the dead stream before
    freeing its cache and requeues the row, which a second worker
    re-prefills on another stream. The spliced pool pages, first token and
    logprob equal those of a run with no kill (qwen3-0.6b reduced, fp32)."""
    from collections import deque
    from repro_torch.core.chaos import ChaosConfig, ChaosInjector
    from repro_torch.rollout.prefill import PrefillWorker, _Job
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    adapters = make_adapters(cfg, 2, seed=0, device="cuda", b_scale=0.2)
    req = make_requests(1, 1, max_new_tokens=4, seed=5)[0]
    req.prompt = list(req.prompt) + [7] * (20 - len(req.prompt))
    out = []
    for kill in (False, True):
        eng = _stage_engine(cfg, params, adapters, paged_kv=True,
                            prefix_cache=False, kv_page_size=8,
                            prefill_chunk=8, chaos=ChaosInjector(ChaosConfig(
                                seed=0, prefill_worker_kill=1.0,
                                max_faults_per_site=1)) if kill else None)
        eng.submit(req)
        w = PrefillWorker(eng, 0)
        row = w._try_pop()
        assert row is not None
        job = _Job(row)
        if kill:
            with torch.no_grad(), torch.cuda.stream(w.stream):
                torch.cuda._sleep(50_000_000)       # keep the chunk in flight
                assert not w._advance(job)          # chunk 1 of 3
            assert eng._chaos.fire("prefill_worker_kill")
            w._die(deque([job]))
            eng._workers = [w]                      # never started: dead
            assert w.death_event is not None and w.stranded
            assert eng._recover_prefill_claims() == 1
            assert w.death_event is None and not w.stranded
            w = PrefillWorker(eng, 1)
            assert w.stream != eng._workers[0].stream
            row = w._try_pop()
            assert row is not None and row.req is req
            job = _Job(row)
        with torch.no_grad(), torch.cuda.stream(w.stream):
            while not w._advance(job):
                pass
        with torch.no_grad():
            assert eng._splice_ready_rows()
        slot = next(s for s, r in enumerate(eng._rows) if r is row)
        pages = torch.tensor(eng._slot_pages[slot], device="cuda")
        torch.cuda.synchronize()
        rr_first = row.gen[0]
        out.append((rr_first, row.lps[0], eng._cache["kp"][:, pages].cpu(),
                    eng._cache["vp"][:, pages].cpu(),
                    int(eng._cache["pos"][slot])))
        eng.check_page_invariants()
        eng._workers = []
        eng.shutdown()
    (f1, l1, k1, v1, p1), (f2, l2, k2, v2, p2) = out
    assert (f1, p1) == (f2, p2) and l1 == l2
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_traced_engine_launches_what_the_untraced_one_does(card):
    """The same requests through the paged engine with and without a
    tracer: equal kernel launches (paged decode, sgmv calls and CUDA
    launches), equal forwards, equal tokens; the tracer saw every
    episode."""
    from repro_torch.obs import Tracer
    cfg = _qwen3_reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    adapters = make_adapters(cfg, 2, seed=0, device="cuda", b_scale=0.2)
    reqs = make_requests(2, 2, max_new_tokens=6, seed=9)
    runs = []
    for tracer in (None, Tracer()):
        eng = ContinuousRolloutEngine(cfg, params, max_slots=4,
                                      max_adapters=2, max_len=64,
                                      paged_kv=True, kv_page_size=8,
                                      tracer=tracer, device="cuda")
        for i, a in enumerate(adapters):
            eng.set_adapters(i, a)
        counts = (paged.LAUNCHES, sgmv.LAUNCHES, sgmv.CUDA_LAUNCHES,
                  gqa.LAUNCHES)
        before = [c.n for c in counts]
        for r in reqs:
            eng.submit(r)
        comps = eng.drain(deadline_s=120.0)
        torch.cuda.synchronize()
        runs.append(([c.n - b for c, b in zip(counts, before)],
                     {k: c.n for k, c in eng.forward_counts.items()},
                     sorted((c.submit_index, list(c.tokens)) for c in comps)))
        if tracer is not None:
            assert len(tracer.components()) == len(reqs)
            assert all(tracer.state_sequence(t)[-1] == "completed"
                       for t in tracer.components())
        eng.shutdown()
    assert runs[0] == runs[1]
    assert runs[0][0][0] > 0 and runs[0][0][1] > 0


# -- the moe, ssm and hybrid families -----------------------------------------

@pytest.mark.parametrize("kernel", ["gqa", "paged"])
@pytest.mark.parametrize("H,hd", [(16, 128), (32, 64)],
                         ids=["deepseek-moe", "zamba2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_decode_kernels_at_the_families_rep1_shapes(card, kernel, H, hd, dtype,
                                                    tol):
    """Both decode kernels at rep 1 with the families' head counts (MHA:
    deepseek-moe 16 heads of 128, zamba2's shared block 32 heads of 64), 16
    rows over a 512-key cache (pages of 16), against the plain versions;
    two calls give the same bits."""
    case = _split_case(card, 16, H, H, hd, 512, 16, dtype,
                       [1, 15, 16, 17, 100, 255, 256, 257, 300, 383, 384,
                        385, 450, 500, 511, 512])
    got, want = _both_kernels(case, 0.0, 0)[kernel]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again, _ = _both_kernels(case, 0.0, 0)[kernel]
    assert torch.equal(got, again)


FAMILY_SGMV = [  # d, dout: the families' adapted projections new to sgmv
    (2048, 8384), (4096, 2048),        # zamba2 ssm_in, ssm_out
    (1536, 6448), (3072, 1536),        # mamba2 ssm_in, ssm_out
    (2048, 16384), (8192, 2048),       # zamba2's shared MLP in, out
    (2048, 5632), (2816, 2048),        # deepseek-moe's shared experts
]


@pytest.mark.parametrize("R", [16, 512])
@pytest.mark.parametrize("d,dout", FAMILY_SGMV)
def test_sgmv_at_the_families_projections(card, d, dout, R):
    """Both epilogues at each new projection shape, bf16 rows of 4 slots,
    in decode (16 rows) and prefill (512 rows): sgmv against sgmv_ref,
    sgmv_add_ bit-equal to sgmv followed by the torch composition and close
    to sgmv_add_ref, one CUDA launch a call."""
    x, a, b, ids = _sgmv_case(card, R, 4, d, 16, dout, torch.bfloat16,
                              "uniform")
    table = sgmv.sgmv_table(ids, 4)
    got = sgmv.sgmv(x, a, b, ids, table=table)
    want = ref.sgmv_ref(x, a, b, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    y0 = torch.randn(R, dout, generator=card, device="cuda").bfloat16()
    y = y0.clone()
    n = sgmv.CUDA_LAUNCHES.n
    sgmv.sgmv_add_(y, x, a, b, table, 2.0)
    assert sgmv.CUDA_LAUNCHES.n - n == 1
    assert torch.equal(y, y0 + (got * 2.0).to(torch.bfloat16))
    _assert_add_close(y, ref.sgmv_add_ref(y0.clone(), x, a, b, ids, 2.0), y0,
                      want * 2.0)


@pytest.mark.parametrize("d,V,layout", [(2048, 32000, "tied"),
                                        (1536, 50280, "tied"),
                                        (2048, 102400, "untied")],
                         ids=["zamba2", "mamba2", "deepseek-moe"])
def test_token_logprob_at_the_families_vocabularies(card, d, V, layout):
    """The bf16 forward and backward at the families' widths and
    vocabularies (50280 leaves a ragged last 128-column tile; deepseek-moe's
    head is untied), 300 rows, against the plain versions; two calls of
    each give the same bits."""
    _assert_bf16_dh(*_bf16_forward_backward(card, 300, d, V, layout, 0.0))


def test_moe_combine_gives_the_same_bits_on_two_calls(card):
    """moe_apply at deepseek-moe's width (64 experts, top 6, 2 shared, d
    2048) on 512 tokens in bf16, with drops at capacity_factor 1.0 (48
    assignments an expert on average against a capacity of 56): two calls
    give the same bits (the combine gathers and sums each token's slots in
    a fixed order: no atomics), and equal the fp32 CPU result of the same
    layer within bf16 rounding."""
    from repro_torch.models import moe
    cfg = REGISTRY["deepseek-moe-16b"]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           capacity_factor=1.0))
    p = moe.moe_init(card, cfg, torch.bfloat16, "cuda")
    x = torch.randn(4, 128, cfg.d_model, generator=card, device="cuda").bfloat16()
    moe.DROPS.reset(True)
    y1, aux1 = moe.moe_apply(x, p, cfg)
    y2, aux2 = moe.moe_apply(x, p, cfg)
    dropped = moe.DROPS.total()
    moe.DROPS.reset(False)
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(aux1, aux2) and dropped > 0
    p32 = tree_map(lambda t: t.float().cpu(), p)
    y_cpu, _ = moe.moe_apply(x.float().cpu(), p32, cfg)
    err = (y1.float().cpu() - y_cpu).abs().max()
    assert err <= 3e-2 * y_cpu.abs().max(), err


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b",
                                  "deepseek-moe-16b"])
def test_family_continuous_paged_on_card_matches_cpu(card, arch):
    """A reduced fp32 model of each family through the paged continuous
    engine (prefix cache on), every resident row preempted at step 4, on
    the card (sgmv, paged_gqa_decode) and on the CPU (plain versions):
    equal tokens, logprobs within 1e-4, equal counters; the kernels launch
    at the family's counts."""
    from repro_torch.lora.adapters import applicable_targets
    from repro_torch.models.model import n_attn_layers
    cfg = dataclasses.replace(reduced(REGISTRY[arch], dtype="float32"),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 2, seed=0, device="cpu", b_scale=0.2)
    reqs = make_requests(2, 3, max_new_tokens=10, seed=4)
    for i, r in enumerate(reqs):
        r.seed = i
    t = applicable_targets(cfg)
    per_fwd = (len(t["layers"]) * cfg.num_layers
               + len(t["shared"]) * n_attn_layers(cfg))
    out = {}
    for dev in ("cpu", "cuda"):
        def mv(tree, dev=dev):
            return tree_map(lambda x: x.to(dev), tree)
        eng = ContinuousRolloutEngine(cfg, mv(params), max_slots=3,
                                      max_adapters=2, max_len=64,
                                      paged_kv=True, kv_page_size=8,
                                      device=dev)
        for i, a in enumerate(adapters):
            eng.set_adapters(i, mv(a))
        n0 = (paged.LAUNCHES.n, sgmv.LAUNCHES.n)
        for r in reqs:
            eng.submit(r)
        comps, steps = [], 0
        while not eng.idle():
            eng.step()
            steps += 1
            eng.check_page_invariants()
            if steps == 4:          # every resident row
                eng.preempt_tenant("tenant-0")
                eng.preempt_tenant("tenant-1")
            comps += eng.drain_completions()
        st = eng.stats
        fwd = sum(c.n for c in eng.forward_counts.values())
        if dev == "cuda":
            assert paged.LAUNCHES.n - n0[0] == n_attn_layers(cfg) * st.decode_steps
            assert sgmv.LAUNCHES.n - n0[1] == per_fwd * fwd
        out[dev] = (sorted((c.submit_index, list(c.tokens), c.gen_logprobs)
                           for c in comps),
                    (st.decode_steps, st.preemptions, st.restores,
                     st.snapshots, st.replays))
        assert st.preemptions > 0 and st.restores > 0
    assert out["cpu"][1] == out["cuda"][1]
    for (i, ta, la), (j, tb, lb) in zip(out["cpu"][0], out["cuda"][0]):
        assert (i, ta) == (j, tb)
        torch.testing.assert_close(torch.tensor(lb), torch.tensor(la),
                                   rtol=1e-4, atol=1e-4)


# -- the encdec family (seamless-m4t-large-v2) and the launch layer -----------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_gqa_decode_at_seamless_decoder_shape(card, dtype, tol):
    """gqa_decode at the decoder's self-attention (16/16 heads of 64, rep
    1), 16 rows over a 512-key cache, against the plain version; two calls
    give the same bits."""
    case = _split_case(card, 16, 16, 16, 64, 512, 16, dtype,
                       [1, 2, 16, 17, 63, 64, 65, 128, 200, 255, 256, 300,
                        400, 500, 511, 512])
    got, want = _both_kernels(case, 0.0, 0)["gqa"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again, _ = _both_kernels(case, 0.0, 0)["gqa"]
    assert torch.equal(got, again)


@pytest.mark.parametrize("R", [16, 128])
@pytest.mark.parametrize("d,dout", [(1024, 1024), (1024, 8192), (8192, 1024)],
                         ids=["qkvo", "mlp_in", "mlp_out"])
def test_sgmv_at_seamless_projections(card, d, dout, R):
    """Both sgmv epilogues at the decoder's adapted projections (gelu MLP
    of 8192), in decode (16 rows) and the served prefill (128 rows)."""
    test_sgmv_at_the_families_projections(card, d, dout, R)


@pytest.mark.parametrize("layout", ["untied", "padded"])
def test_token_logprob_at_seamless_vocabulary(card, layout):
    """The bf16 forward and backward at seamless's untied head, d 1024 and
    V 256206 (not a multiple of 8: W's tiles load 2 bytes at a time), 300
    rows, against the plain versions, and on a [:, :V] view of a head whose
    rows are padded to 256208 (the backward's chunks but the last load 16
    bytes at a time): lp, entropy and lse within 1e-3, dh within 1e-2 of
    its scale, two calls of each with the same bits."""
    R, d, V = 300, 1024, 256206
    h, w, t = _bf16_inputs(card, R, d, V, "untied")
    if layout == "padded":
        w = torch.zeros(d, V + 2, device="cuda", dtype=torch.bfloat16)[:, :V] \
            .copy_(w)
        assert w.stride() == (V + 2, 1)
    lp, ent, lse = tlp.token_logprob_fwd(h, w, t)
    again = tlp.token_logprob_fwd(h, w, t)
    want = ref.token_logprob_stats_ref(h, w, t)
    for got, g2, wv in zip((lp, ent, lse), again, want):
        torch.testing.assert_close(got, wv, rtol=1e-3, atol=1e-3)
        assert torch.equal(got, g2)
    g_lp = torch.randn(R, generator=card, device="cuda") / R
    g_ent = torch.randn(R, generator=card, device="cuda") / R
    dh = tlp.token_logprob_bwd(h, w, t, want[2], want[1], g_lp, g_ent)
    dh2 = tlp.token_logprob_bwd(h, w, t, want[2], want[1], g_lp, g_ent)
    want_dh = ref.token_logprob_bwd_ref(h, w, t, want[2], want[1], g_lp, g_ent)
    assert torch.equal(dh, dh2)
    err = (dh.float() - want_dh.float()).abs().max()
    assert err <= 1e-2 * want_dh.float().abs().max(), err


@pytest.mark.parametrize("layout,V,fwd,bwd_scalar", [
    ("tied", 5003, 1, 0), ("untied", 5003, 0, "all"), ("untied", 5008, 1, 0),
    ("padded", 256206, 0, 1)])
def test_token_logprob_reports_how_it_loads_w(card, layout, V, fwd, bwd_scalar):
    """The launchers' report of W's staging (FWD_W_VECTOR, BWD_W_VECTOR):
    16-byte copies where the contiguous stride is 1 and the other stride
    and the extent along it are multiples of 8 (the tied transpose at any
    V; an untied head whose V is a multiple of 8), element loads otherwise
    (an untied head at V 5003); a [:, :V] view of rows padded to 8 takes
    them in every backward chunk but the ragged last one."""
    R, d = 300, 1024
    h, w, t = _bf16_inputs(card, R, d, V, "untied" if layout == "padded" else layout)
    if layout == "padded":
        w = torch.zeros(d, V + 2, device="cuda", dtype=torch.bfloat16)[:, :V] \
            .copy_(w)
    f0 = tlp.FWD_W_VECTOR.n
    _, ent, lse = tlp.token_logprob_fwd(h, w, t)
    assert tlp.FWD_W_VECTOR.n - f0 == fwd
    g = torch.full((R,), 1.0 / R, device="cuda")
    n0, b0 = tlp.BWD_CUDA_LAUNCHES.n, tlp.BWD_W_VECTOR.n
    tlp.token_logprob_bwd(h, w, t, lse, ent, g, g)
    chunks = (tlp.BWD_CUDA_LAUNCHES.n - n0 - 1) // 2
    assert chunks == -(-V // tlp.backward_plan(R, d, V).vc)
    scalar = chunks if bwd_scalar == "all" else bwd_scalar
    assert tlp.BWD_W_VECTOR.n - b0 == chunks - scalar


def test_encdec_step_builders_on_card_match_cpu(card):
    """launch.specs' prefill and decode step builders on the reduced fp32
    seamless: the card (sgmv, gqa_decode; the cross-attention plain) against
    the CPU, logits within 1e-4; exact launches (6 x layers sgmv a forward,
    layers gqa_decode a decode step); then the LoRA GRPO step through
    build_train_step (token_logprob 1 forward, 1 backward) against the CPU,
    loss and metrics within 1e-4."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.lora.adapters import stack_adapters
    from repro_torch.models import init_cache
    from repro_torch.train.optimizer import adamw_init
    cfg = reduced(REGISTRY["seamless-m4t-large-v2"], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ads = make_adapters(cfg, specs.NUM_TENANTS, seed=0, device="cpu", b_scale=0.2)
    g = torch.Generator().manual_seed(1)
    B, S, L = 4, 16, cfg.num_layers
    toks = torch.randint(1, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    lens = torch.tensor([16, 9, 12, 5], dtype=torch.int32)
    ids = torch.tensor([0, 3, 5, 7], dtype=torch.int32)
    enc = torch.randn(B, S // 4, cfg.d_model, generator=g)
    cur = torch.randint(1, cfg.vocab_size, (3, B), generator=g, dtype=torch.int32)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (16, 12), generator=g,
                                     dtype=torch.int32),
             "prompt_lens": torch.randint(2, 6, (16,), generator=g, dtype=torch.int32),
             "total_lens": torch.randint(7, 13, (16,), generator=g, dtype=torch.int32),
             "rewards": torch.rand(16, generator=g),
             "enc_embeds": torch.randn(16, 3, cfg.d_model, generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        def mv(tree, dev=dev):
            return tree_map(lambda x: x.to(dev), tree)
        p, stacked = mv(params), stack_adapters([mv(a) for a in ads])
        n0 = (gqa.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n)
        logs = []
        lg, cache = specs.build_prefill_step(cfg)(
            p, stacked, ids.to(dev), toks.to(dev), lens.to(dev),
            init_cache(cfg, B, 32, enc_len=S // 4, device=dev), enc.to(dev))
        logs.append(lg.cpu())
        for t in range(3):
            lg, cache = specs.build_decode_step(cfg)(p, stacked, ids.to(dev),
                                                     cur[t].to(dev), cache)
            logs.append(lg.cpu())
        if dev == "cuda":
            assert (gqa.LAUNCHES.n - n0[0], sgmv.CUDA_LAUNCHES.n - n0[1]) == \
                (3 * L, 6 * L * 4)
        n1 = (tlp.FWD_LAUNCHES.n, tlp.BWD_LAUNCHES.n)
        lora = mv(ads[1])
        _, _, m = specs.build_train_step(cfg, ShapeConfig("t", 12, 16, "train"))(
            p, lora, adamw_init(lora), mv(batch))
        if dev == "cuda":
            assert (tlp.FWD_LAUNCHES.n - n1[0], tlp.BWD_LAUNCHES.n - n1[1]) == (1, 1)
        out[dev] = (logs, {k: float(v) for k, v in m.items()})
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    for k, v in out["cpu"][1].items():
        assert abs(out["cuda"][1][k] - v) <= 1e-4, k


def test_build_train_step_launches_the_kernel_by_default(card):
    """launch.specs.build_train_step on the card: by default the policy
    logprobs go through token_logprob (1 forward, 1 backward launch);
    use_logprob_kernel=False (the dry run's chunked path) launches neither;
    the two steps' loss and metrics agree within 1e-4 (reduced fp32
    qwen3-0.6b)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import specs
    from repro_torch.train.optimizer import adamw_init
    cfg = reduced(REGISTRY["qwen3-0.6b"], dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    lora = make_adapters(cfg, 1, seed=1, device="cuda", b_scale=0.2)[0]
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (16, 12), generator=g,
                                     device="cuda", dtype=torch.int32),
             "prompt_lens": torch.randint(2, 6, (16,), generator=g, device="cuda",
                                          dtype=torch.int32),
             "total_lens": torch.randint(7, 13, (16,), generator=g, device="cuda",
                                         dtype=torch.int32),
             "rewards": torch.rand(16, generator=g, device="cuda")}
    shape = ShapeConfig("t", 12, 16, "train")
    out = {}
    for kw, want in (({}, (1, 1)), ({"use_logprob_kernel": False}, (0, 0))):
        n0 = (tlp.FWD_LAUNCHES.n, tlp.BWD_LAUNCHES.n)
        _, _, m = specs.build_train_step(cfg, shape, **kw)(params, lora,
                                                           adamw_init(lora), batch)
        assert (tlp.FWD_LAUNCHES.n - n0[0], tlp.BWD_LAUNCHES.n - n0[1]) == want
        out[bool(kw)] = {k: float(v) for k, v in m.items()}
    for k, v in out[False].items():
        assert abs(out[True][k] - v) <= 1e-4, k


def test_host_mesh_steps_on_card_equal_plain(card):
    """The GRPO step and a decode step of launch.specs on the host mesh (a
    (1, 1) mesh over NCCL, every input a DTensor placed by the specs) give
    the plain steps' bits and launch the same kernels, which take the
    DTensors through their wrappers' boundary (reduced fp32 qwen3-0.6b)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import shardings as sh, specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.lora.adapters import stack_adapters
    from repro_torch.models import init_cache, tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.sharding import mesh_context
    cfg = reduced(REGISTRY["qwen3-0.6b"], dtype="float32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    lora = make_adapters(cfg, 1, seed=1, device="cuda", b_scale=0.2)[0]
    ads = stack_adapters(make_adapters(cfg, specs.NUM_TENANTS, seed=0,
                                       device="cuda", b_scale=0.2))
    g = torch.Generator(device="cuda").manual_seed(2)
    R, B = 16, 4
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (R, 12), generator=g,
                                     device="cuda", dtype=torch.int32),
             "prompt_lens": torch.full((R,), 3, device="cuda", dtype=torch.int32),
             "total_lens": torch.full((R,), 10, device="cuda", dtype=torch.int32),
             "rewards": torch.rand(R, generator=g, device="cuda")}
    ids = torch.tensor([0, 3, 5, 7], dtype=torch.int32, device="cuda")
    cur = torch.randint(1, cfg.vocab_size, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    _, cache = specs.build_prefill_step(cfg)(
        params, ads, ids, batch["tokens"][:B], torch.full((B,), 12, device="cuda",
                                                         dtype=torch.int32),
        init_cache(cfg, B, 16, device="cuda"))
    train = specs.build_train_step(cfg, ShapeConfig("t", 12, R, "train"))
    decode = specs.build_decode_step(cfg)
    counters = (gqa.LAUNCHES, sgmv.LAUNCHES, tlp.FWD_LAUNCHES, tlp.BWD_LAUNCHES)

    def run(p, lo, opt, bt, a, i, c, t):
        n0 = [k.n for k in counters]
        res = train(p, lo, opt, bt), decode(p, a, i, t, c)
        return res, [k.n - n for k, n in zip(counters, n0)]

    def clone(tree):
        return {k: v.clone() for k, v in tree.items()}
    (plain, plain_n) = run(params, lora, adamw_init(lora), batch, ads, ids,
                           clone(cache), cur)
    mesh = make_host_mesh()
    try:
        with mesh_context(mesh), implicit_replication():
            lspec = sh.lora_specs(cfg, lora, mesh)
            rest = {"ids": ids, "cur": cur}
            rest = sh.distribute(rest, sh.batch_specs(rest, mesh, B), mesh)
            (meshed, mesh_n) = run(
                sh.distribute(params, sh.param_specs(cfg, params, mesh), mesh),
                sh.distribute(lora, lspec, mesh),
                sh.distribute(adamw_init(lora), sh.opt_specs(lspec), mesh),
                sh.distribute(batch, sh.batch_specs(batch, mesh, R), mesh),
                sh.distribute(ads, sh.lora_specs(cfg, ads, mesh, batched=True), mesh),
                rest["ids"], sh.distribute(clone(cache), sh.cache_specs(cfg, cache,
                                                                        mesh, B), mesh),
                rest["cur"])
            (new_m, opt_m, met_m), (log_m, cache_m) = meshed
            assert isinstance(log_m, DTensor) and isinstance(cache_m["k"], DTensor)
            new_m, mom_m, cache_m = sh.gather(new_m), sh.gather(opt_m["m"]), \
                sh.gather(cache_m)
            met_m = {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in met_m.items()}
            log_m = log_m.full_tensor()
    finally:
        dist.destroy_process_group()
    (new_p, opt_p, met_p), (log_p, cache_p) = plain
    assert mesh_n == plain_n and plain_n == [cfg.num_layers, 6 * cfg.num_layers, 1, 1]
    assert all(torch.equal(met_p[k], met_m[k]) for k in met_p)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new_p), tree_leaves(new_m)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(opt_p["m"]),
                                                 tree_leaves(mom_m)))
    assert torch.equal(log_p, log_m)
    assert all(torch.equal(cache_p[k], cache_m[k]) for k in cache_p)


def test_roofline_peaks_of_this_card(card):
    """launch.roofline finds the card's data-sheet peaks by its name (an H100
    SXM here), and nvidia-smi's line names the same card."""
    from repro_torch.launch import roofline
    name = torch.cuda.get_device_name(0)
    peaks = roofline.device_peaks()
    assert peaks is roofline.peaks_for(name) is roofline.H100_SXM
    line = roofline.card_line()
    assert "H100" in line and line.strip().endswith("W"), line


# -- the analysis package's sentinel, and the sharded port's two torch-2.11
#    repairs (the card host's torch) ------------------------------------------

def test_sentinel_steady_decode_syncs_on_card(card):
    """RecompileSentinel over steady-state paged decode on the card (reduced
    qwen3 in bf16, 4 slots, EOS out of reach): no new plan, library load or
    step signature after warm-up, and the same synchronizing calls in every
    step but for the block table's upload in the steps that changed it;
    the step's own waits (its stream, the token and logprob reads) among
    them."""
    import numpy as np

    from repro_torch.analysis import RecompileSentinel
    cfg = dataclasses.replace(reduced(REGISTRY["qwen3-0.6b"]),
                              vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, card, "cuda")
    eng = ContinuousRolloutEngine(cfg, params, max_slots=4, max_adapters=2,
                                  max_len=128, paged_kv=True,
                                  prefix_cache=False, kv_page_size=8,
                                  kv_pool_pages=64, device="cuda")
    for i, a in enumerate(make_adapters(cfg, 2, seed=0, device="cuda",
                                        b_scale=0.02)):
        eng.set_adapters(i, a)
    eos = tok.EOS
    try:
        tok.EOS = -1                   # every row runs to its budget
        for r in make_requests(2, 2, max_new_tokens=96, seed=3):
            eng.submit(r)
        sent = RecompileSentinel()
        assert "_step_fn" in sent.track_engine(eng)
        while eng.stats.decode_steps < 4 or sum(
                r is not None and r.status == "active" for r in eng._rows) < 4:
            eng.step()
        sent.mark()
        steps = []
        for _ in range(12):
            tbl = eng._tbl_host.copy()
            _, syncs = sent.step_syncs(eng.step)
            steps.append((syncs, not np.array_equal(tbl, eng._tbl_host)))
    finally:
        tok.EOS = eos
        eng.shutdown()
    assert sent.new_compiles() == {}
    base = [s for s, changed in steps if not changed]
    assert base and all(s == base[0] for s in base)
    assert sum(base[0].values()) >= 3
    assert any("_sync_stream" in site for site in base[0])
    for s, changed in steps:
        if changed:
            assert sum((s - base[0]).values()) == 1 and not base[0] - s


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-780m",
                                  "deepseek-moe-16b"])
def test_train_cells_of_the_repairs_on_this_torch(card, arch):
    """The dry run's train_4k cell on the 16x16 mesh at published width, two
    layers deep, on this host's torch: the ssm and hybrid cells run (torch
    2.11 has no sharding strategy for cumsum's backward, aten.flip), and
    deepseek-moe-16b's plan keeps its rows and vocabulary split (torch
    2.11 made the loss's logits whole: 108.83 GB a device at 28 layers)."""
    from repro_torch.configs import shapes_for
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    cfg = dataclasses.replace(REGISTRY[arch], num_layers=2)
    shape = {s.name: s for s in shapes_for(cfg)}["train_4k"]
    with fake_world(256):
        rec = dryrun.cell_record(cfg, shape, make_production_mesh(
            multi_pod=False, kind="train", device_type="cuda"))
    assert rec["ok"]
    assert rec["bytes_per_device"] < 80e9, rec["temp_by_op"]
    assert rec["reshards"]["embed_rows"] > 0
    if arch != "deepseek-moe-16b":
        assert rec["reshards"]["local_cumsum"] > 0
    else:
        assert rec["reshards"]["moe_local"] > 0
        assert rec["bytes_per_device"] < 8e9, rec["temp_by_op"]
