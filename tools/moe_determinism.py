#!/usr/bin/env python3
"""Run-to-run determinism of the MoE family on the paged continuous engine,
on one CUDA card.

    python3 tools/moe_determinism.py [--layers N] [--variants a,b,...]

deepseek-moe-16b at full width in bf16 (random weights from seed 0, as
chip_smoke.py's phase 14 draws them; ``--layers`` cuts the depth) serves
chip_smoke.py's phase 8 schedule: 16 slots, 4 tenants x 8 gsm8k requests of
64 tokens, tenant 1 preempted after decode step 10. Each variant serves it
twice, on two fresh engines in this one process, and compares the token
streams, the logprobs' bits and the per-forward counts of assignments dropped
at expert capacity.

Variants:
  port        the engine as it is: a frozen or empty decode lane takes no
              expert capacity (repro_torch.models.moe, ``live``)
  reference   every lane takes capacity, as the JAX package routes it
  ref_zeroed  `reference`, with every K/V write that lands on the paged
              pool's scratch page (empty lanes' decode writes, a refill's
              sentinel chunks) writing zeros, so that an empty lane reads
              the same values on every run
  router      the fp32 router alone: one batch twice, and its rows inside a
              batch of twice the size

Prints one JSON line a variant and exits 0; the verdict is in the numbers.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402  (constants of phase 8 and 14)


def serve_once(torch, cfg, params, adapters):
    """Phase 8's schedule on a fresh engine: (streams, drops a forward,
    empty lanes at each step's first forward)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import moe
    from repro_torch.rollout.engine import ContinuousRolloutEngine

    reqs = make_requests(cs.TENANTS, cs.CONT_PER_TENANT,
                         max_new_tokens=cs.CONT_MAX_NEW, seed=8)
    late = [r for r in reqs if r.task_id == f"tenant-{cs.TENANTS - 1}"]
    for i, r in enumerate(reqs):
        r.seed = 1000 + i
        r.priority = 1 if r in late else 0
    eng = ContinuousRolloutEngine(
        cfg, params, max_slots=cs.CONT_SLOTS, max_adapters=cs.TENANTS,
        max_len=cs.CONT_MAX_LEN, paged_kv=True, prefix_cache=False,
        kv_page_size=cs.PAGE, kv_pool_pages=cs.POOL_PAGES, device="cuda")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    for r in reqs:
        if r not in late:
            eng.submit(r)
    moe.DROPS.reset(True)
    comps, marks, preempted = [], [], False
    while not eng.idle():
        empty = sum(r is None or r.status != "active" for r in eng._rows)
        marks.append((len(moe.DROPS._parts), empty))
        eng.step()
        if not preempted and eng.stats.decode_steps >= cs.PREEMPT_AT:
            preempted = eng.preempt_tenant("tenant-1")
            for r in late:
                eng.submit(r)
        comps += eng.drain_completions()
    torch.cuda.synchronize()
    drops = [int(t) for t in moe.DROPS._parts]
    moe.DROPS.reset(False)
    comps.sort(key=lambda c: c.submit_index)
    return ([(list(c.tokens), [float(x) for x in c.gen_logprobs]) for c in comps],
            drops, marks)


def compare(a, b):
    (sa, da, marks), (sb, db, _) = a, b
    first = next((i for i, (x, y) in enumerate(zip(da, db)) if x != y), None)
    step = empty = None
    if first is not None:
        step = max(i for i, (n, _) in enumerate(marks) if n <= first)
        empty = marks[step][1]
    return dict(rows=len(sa),
                rows_tokens_differ=sum(x[0] != y[0] for x, y in zip(sa, sb)),
                rows_logprob_bits_differ=sum(x[1] != y[1] for x, y in zip(sa, sb)),
                drops=[sum(da), sum(db)], forwards=len(da),
                first_forward_differing=first, its_engine_step=step,
                lanes_not_active_then=empty)


def router_bits(torch, cfg, params):
    from repro_torch.models import moe, tree_index
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((16, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    x2 = torch.cat([x, torch.randn_like(x)])
    w = tree_index(params["layers"], 0)["moe"].router
    a, ia, _ = moe.route(x, w, cfg.moe)
    b, ib, _ = moe.route(x, w, cfg.moe)
    c, ic, _ = moe.route(x2, w, cfg.moe)
    return dict(same_batch_bits_equal=bool(torch.equal(a, b) and torch.equal(ia, ib)),
                rows_in_double_batch_bits_equal=bool(torch.equal(a, c[:16])
                                                     and torch.equal(ia, ic[:16])))


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--variants", default="port,reference,ref_zeroed,router")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import repro_torch.models as M
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_adapters
    from repro_torch.models import model as model_mod
    from repro_torch.rollout import engine as engine_mod

    cfg = get_config(cs.P14_MOE)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    adapters = make_adapters(cfg, cs.TENANTS, seed=0, device="cuda",
                             b_scale=cs.B_SCALE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"{cfg.name}: {cfg.num_layers} layers, capacity_factor "
          f"{cfg.moe.capacity_factor}, on {card}", flush=True)

    plain_moe, plain_write = model_mod.moe_apply, model_mod._write_kv_paged
    plain_scatter = engine_mod._paged_scatter

    def all_lanes(x, p, cfg_, lora=None, live=None):
        return plain_moe(x, p, cfg_, lora)

    def zeroed_write(kp, vp, tbl, k_new, v_new, pos):
        page, sentinel, max_pg = kp.shape[1], kp.shape[0] - 1, tbl.shape[1]
        lpage = (pos // page).long()
        pidx = tbl.gather(1, lpage.clamp(max=max_pg - 1)[:, None])[:, 0]
        real = ((lpage < max_pg) & (pidx != sentinel))[:, None, None, None]
        plain_write(kp, vp, tbl, torch.where(real, k_new, 0),
                    torch.where(real, v_new, 0), pos)

    def zeroed_scatter(cache, pk, pv, dest_pages, page):
        real = (dest_pages != cache["kp"].shape[1] - 1).repeat_interleave(page, 1)
        real = real[None, :, :, None, None]
        plain_scatter(cache, torch.where(real, pk, 0), torch.where(real, pv, 0),
                      dest_pages, page)

    for v in args.variants.split(","):
        t0 = time.monotonic()
        if v == "router":
            out = router_bits(torch, cfg, params)
        else:
            model_mod.moe_apply = all_lanes if v != "port" else plain_moe
            model_mod._write_kv_paged = zeroed_write if v == "ref_zeroed" else plain_write
            engine_mod._paged_scatter = (zeroed_scatter if v == "ref_zeroed"
                                         else plain_scatter)
            out = compare(serve_once(torch, cfg, params, adapters),
                          serve_once(torch, cfg, params, adapters))
        model_mod.moe_apply, model_mod._write_kv_paged = plain_moe, plain_write
        engine_mod._paged_scatter = plain_scatter
        out = dict(variant=v, seconds=round(time.monotonic() - t0, 1), **out)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
