"""Real sharded numerics: the port's GRPO step and decode step on DTensors
placed by ``launch.shardings``' specs, against the JAX package's steps run
unsharded on the same numpy weights.

- Four gloo ranks on a 2×2 (data, model) CPU mesh, spawned with their own
  join timeout: reduced fp32 granite through ``make_train_step`` with
  ``TrainConfig(group_size=2, accum_steps=2)`` (the reference's
  tests/test_sharding.py settings) — loss, metrics and new LoRA within
  1e-5 of the JAX step — and one ``build_decode_step`` over eight stacked
  adapters after a JAX prefill — logits and every cache entry within 1e-5.
- The same two steps on a single-rank ``make_host_mesh("cpu")``.
Each rank (tests/torch_sharded_worker.py, which imports no JAX) gathers its
results whole (``shardings.gather``) and sends them back as numpy; the
parent compares."""
import multiprocessing as mp
import queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import torch_sharded_worker
from conftest import tiny
from repro.launch import specs as j_specs
from repro.lora.adapters import init_lora, stack_adapters as jax_stack
from repro.models import init_cache as jax_init_cache, init_params
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro.train.train_step import (TrainConfig as JTrainConfig,
                                    make_train_step as jax_make_train_step)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-3-2b"
R, S = 8, 32                   # train rows and length (4 groups of 2)
B, P, MAXLEN = 4, 12, 16       # decode rows, prompt length, cache length
JOIN_S = 120


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs():
    """The numpy weights and batches both packages take, and the JAX
    package's unsharded results."""
    cfg = tiny(ARCH)
    params = _np(init_params(jax.random.PRNGKey(0), cfg))
    rs = np.random.RandomState(1)
    tenants = []
    for t in range(j_specs.NUM_TENANTS):
        tree = _np(init_lora(jax.random.PRNGKey(10 + t), cfg))
        for sub in tree.values():
            for leaf in sub.values():
                leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        tenants.append(tree)
    lora = tenants[0]
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (R, S)).astype(np.int32),
             "prompt_lens": rs.randint(2, 8, R).astype(np.int32),
             "total_lens": rs.randint(12, S + 1, R).astype(np.int32),
             "rewards": rs.rand(R).astype(np.float32)}
    tc = JTrainConfig(group_size=2, accum_steps=2)
    jl = jax.tree.map(jnp.asarray, lora)
    jp = jax.tree.map(jnp.asarray, params)
    new, opt, metrics = jax.jit(jax_make_train_step(cfg, tc))(
        jp, jl, jax_adamw_init(jl), jax.tree.map(jnp.asarray, batch))
    train_want = {"lora": _np(new), "m": _np(opt["m"]),
                  "metrics": {k: float(v) for k, v in metrics.items()}}

    ads = jax_stack([jax.tree.map(jnp.asarray, t) for t in tenants])
    ids = np.array([0, 3, 5, 7], np.int32)
    toks = rs.randint(1, cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([12, 9, 7, 5], np.int32)
    _, cache = j_specs.build_prefill_step(cfg)(
        jp, ads, jnp.asarray(ids), jnp.asarray(toks), jnp.asarray(lens),
        jax_init_cache(cfg, B, MAXLEN))
    cur = rs.randint(1, cfg.vocab_size, (B,)).astype(np.int32)
    logits, after = j_specs.build_decode_step(cfg)(
        jp, ads, jnp.asarray(ids), jnp.asarray(cur), cache)
    decode_want = {"logits": np.asarray(logits), "cache": _np(after)}
    # the ranks get the port's tensors: they import neither jax nor repro
    pcfg = pt_reduced(PT_REGISTRY[ARCH], dtype="float32")
    payload = {"params": bridge.params_from_jax(params, pcfg, "cpu"),
               "lora": bridge.lora_from_jax(lora, "cpu"),
               "tenants": [bridge.lora_from_jax(t, "cpu") for t in tenants],
               "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
               "ids": torch.from_numpy(ids), "cur": torch.from_numpy(cur),
               "cache": bridge.lora_from_jax(_np(cache), "cpu")}
    return payload, train_want, decode_want


def _spawn(world, payload, tmp_path, target=None):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    if target is None:
        target, extra = torch_sharded_worker.run_rank, (payload,)
    else:
        extra = ()
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "store"), *extra,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            rank, res = results.get(timeout=JOIN_S)
            got[rank] = res
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(not p.is_alive() for p in procs)
    assert len(got) == world, f"ranks {sorted(got)} of {world} reported"
    for rank, res in got.items():
        assert not isinstance(res, str), f"rank {rank}:\n{res}"
    return got


@pytest.fixture(scope="module")
def reference():
    return _inputs()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("world", [4, 1])
def test_sharded_steps_equal_the_unsharded_reference(world, reference,
                                                     tmp_path):
    """Every rank's gathered results equal the JAX package's unsharded
    step: the train step's metrics, new adapters and first moments, and the
    decode step's logits and cache, fp32 within 1e-5."""
    payload, train_want, decode_want = reference
    got = _spawn(world, payload, tmp_path)
    for rank, res in got.items():
        assert set(res["metrics"]) >= set(train_want["metrics"])
        for k, v in train_want["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, err_msg=k, **TOL)
        for name in ("lora", "m"):
            want, have = _flat(train_want[name]), _flat(res[name])
            assert set(have) == set(want)
            for k in want:
                np.testing.assert_allclose(have[k], want[k],
                                           err_msg=f"{rank} {name}{k}", **TOL)
        np.testing.assert_allclose(res["logits"], decode_want["logits"],
                                   **TOL)
        want = decode_want["cache"]
        assert set(res["cache"]) == set(want)
        for k in want:
            np.testing.assert_allclose(res["cache"][k], want[k],
                                       err_msg=k, **TOL)


def test_moe_layer_expert_parallel_equals_the_plain_layer(tmp_path):
    """The MoE layer on a 2×2 gloo mesh (rows over "data", experts over
    "model") builds its dispatch buffer and combine shard by shard
    (``models.moe._dispatch_local``/``_combine_local``, counted as
    "moe_local"): its output, input gradient and expert weights' gradients
    equal the plain layer's, fp32 within 1e-5, on every rank."""
    got = _spawn(4, None, tmp_path,
                 target=torch_sharded_worker.run_moe_rank)
    for rank, res in got.items():
        assert res["reshards"].get("moe_local", 0) >= 1, res["reshards"]
        for name, w, h in zip(("y", "dx", "dw_in", "dw_out"), res["want"],
                              res["have"]):
            np.testing.assert_allclose(h, w, err_msg=f"{rank} {name}", **TOL)
