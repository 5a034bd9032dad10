"""How ``correct`` is decided: the plain reference (the module the
configuration names under ``reference``), fp32 with TF32 off, over what the
timed path produced, once the window has closed and the program is
released.

The check tenants: two drawn from the seed among those that made three
updates (the driver lets the runtime run past the close until two have).

Trained rows. The reference follows each check tenant's first three
updates from the benchmark's initial adapters over the same batches. Each
update's behaviour logprobs are the reference's own, under its own adapters
of the version that decoded each token (the row's version segments, which
the probes read off the installs): nothing the program computed enters the
reference but the tokens, the rewards and the masks. A leaf is one layer's
a or b of one target; leaves whose reference gradient is under a thousandth
of the median leaf's are left out. Three numbers, the widest over the check
tenants:
  loss_gap     the widest |program loss - reference loss| over the steps;
  grad_gap     over the leaves, the widest gap between the norm of the
               first gradient as the program's optimizer got it (its first
               moment after one step over 1 - b1) and the reference's
               clipped gradient, over the larger of the reference leaf's
               norm and the median leaf's;
  update_gap   the same of the change of each leaf over the three steps.

Served rows. A sample drawn from the seed of the check tenants' finished
requests decoded under versions 0 to 3, the window's first, with the
longest of each kind in it: greedy rows (the first row of every
``greedy_every``-th group decodes greedily) and sampled rows, each cut to
the tokens one version served. The reference judges each under that
version's adapters as the program committed them: the benchmark's own for
version 0, and for 1 to 3 the program's state, made by the three updates
the trained numbers above check from the start. (Under the reference's
own adapters the gap would add two trainings' drift, in two precisions, to
the serving path's error.) Two numbers:
  greedy_gap   the widest gap, in logits, by which a greedy token's
               reference logit lies below the reference's best at its
               position;
  logprob_gap  the widest |served logprob - reference logprob| over the
               sampled and greedy tokens.
The control puts the reference in the program's place computed with fp8
(e4m3) base weights (``calibrate.py``); it is not run by the benchmark's
own runs.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rlbench.harness.driver import CHECK_TENANTS, CHECK_UPDATES
from rlbench.reference.grpo import Hyper, Row, adam_init, grpo_step

GREEDY_ROWS = 4
SAMPLED_ROWS = 4


def _lora(tree):
    return tree["layers"] if "layers" in tree else tree


def ref_model(st, quant: Optional[str] = None):
    """The configuration's plain reference over the run's base weights."""
    mod = st.cell.reference
    mod.fp32_strict()
    return mod.RefModel(st.cell.config, st.weights, quant=quant)


def check_tenants(st) -> List[str]:
    """Two tenants drawn from the seed among those with three updates."""
    ok = sorted(t for t, log in st.probes.train_log.items()
                if len(log) >= CHECK_UPDATES)
    rng = np.random.default_rng([st.seed % (2 ** 63), 13])
    return [ok[int(i)] for i in
            sorted(rng.permutation(len(ok))[:CHECK_TENANTS])]


def pick_served(st, tids: Sequence[str]) -> List[Any]:
    """The served sample of the check tenants under versions 0 to 3: window
    rows first (rows finished before or after it only where the window
    finished none of a kind), the longest of each kind, then rows drawn
    from the seed."""
    rng = np.random.default_rng([st.seed % (2 ** 63), 11])
    served = [r for r in st.probes.served
              if r.tid in tids and r.version <= CHECK_UPDATES]
    out = []
    for greedy, n in ((True, GREEDY_ROWS), (False, SAMPLED_ROWS)):
        rows = [r for r in served if r.greedy == greedy
                and st.t_open <= r.finished_at <= st.t_close]
        if not rows:
            rows = [r for r in served if r.greedy == greedy]
        if not rows:
            continue
        longest = max(range(len(rows)),
                      key=lambda i: len(rows[i].tokens) - rows[i].prompt_len)
        rest = [i for i in range(len(rows)) if i != longest]
        take = [longest] + [int(i) for i in rng.permutation(rest)[:n - 1]]
        out.extend(rows[i] for i in take)
    return out


def served_readings(st, model, rows: Sequence[Any],
                    control=None) -> Dict[str, float]:
    """The two served numbers of the program, or of `control` put in its
    place (its own best token at each greedy position; its logprob of each
    served token)."""
    dev = model.w["embed"].device
    greedy_gap, lp_gap, n_tok = 0.0, 0.0, 0
    for r in rows:
        tree = _lora(st.probes.versions[(r.tid, r.version)])
        tok = torch.tensor(r.tokens, dtype=torch.long, device=dev)
        lp_ref, gap_ref, _ = model.next_token_stats(tok, r.prompt_len, tree)
        n = lp_ref.shape[0]
        n_tok += n
        if control is None:
            lp = torch.tensor(r.logprobs[:n], dtype=torch.float32, device=dev)
            gaps = gap_ref
        else:
            lp, _, top = control.next_token_stats(tok, r.prompt_len, tree)
            with torch.no_grad():
                h = model.hidden(tok, tree)
                z = model.logits(h[r.prompt_len - 1:tok.shape[0] - 1])
                gaps = z.max(dim=1).values - z.gather(1, top[:, None])[:, 0]
        lp_gap = max(lp_gap, float((lp - lp_ref).abs().max()))
        if r.greedy:
            greedy_gap = max(greedy_gap, float(gaps.max()))
    return {"greedy_gap": greedy_gap, "logprob_gap": lp_gap,
            "served_tokens": float(n_tok), "served_rows": float(len(rows))}


def _slices(tree) -> Dict[Tuple[str, str, int], torch.Tensor]:
    out = {}
    for tgt, ab in _lora(tree).items():
        for k in ("a", "b"):
            for i in range(ab[k].shape[0]):
                out[(tgt, k, i)] = ab[k][i]
    return out


def _norms(tree) -> Dict[Tuple[str, str, int], float]:
    return {k: float(v.double().norm()) for k, v in _slices(tree).items()}


def _sub(x, y):
    x, y = _lora(x), _lora(y)
    return {t: {k: x[t][k].float() - y[t][k].float() for k in ab}
            for t, ab in x.items()}


def leaf_gap(prog: Dict, ref: Dict, keep: Sequence) -> Tuple[float, Any]:
    """The widest |‖prog leaf‖ - ‖ref leaf‖| over max(‖ref leaf‖, median)."""
    med = float(np.median([ref[k] for k in keep]))
    worst, where = 0.0, None
    for k in keep:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, where = g, k
    return worst, where


def batch_rows(rec, model, params_of) -> List[Row]:
    """A recorded batch's rows, with the behaviour logprobs worked out by
    `model` under its adapters of the version that decoded each token."""
    rows = []
    dev = model.w["embed"].device
    for j in range(rec.tokens.shape[0]):
        p, t = int(rec.prompt_lens[j]), int(rec.total_lens[j])
        tok = torch.tensor(rec.tokens[j, :t], dtype=torch.long, device=dev)
        beh = torch.empty(t - p, dtype=torch.float32, device=dev)
        segs = rec.segments[j]
        for k, (a, v) in enumerate(segs):
            b = segs[k + 1][0] if k + 1 < len(segs) else t - p
            if a >= t - p or b <= a:
                continue
            with torch.no_grad():
                lp = model.completion_logprobs(tok, p, params_of(v))
            beh[a:b] = lp[a:b]
        rows.append(Row(tokens=tok.tolist(), prompt_len=p,
                        mask=rec.loss_mask[j, p - 1:t - 1].tolist(),
                        reward=float(rec.rewards[j]),
                        behaviour=beh.tolist()))
    return rows


def follow(st, model, tid: str, keep_rows=None) -> Dict[str, Any]:
    """The reference's first three updates of tenant `tid` over its
    recorded batches, from the benchmark's initial adapters: their losses,
    the first clipped gradient and the adapters after the third."""
    group = st.traffic.mix["group_size"]
    hp = Hyper(lr=st.lr, is_cap=2.0 if st.traffic.mix["max_staleness"] > 0 else 0.0)
    idx = int(tid[1:])
    params = {t: {k: v.float().clone() for k, v in ab.items()}
              for t, ab in st.adapters0[idx].items()}
    versions = [params]
    opt = adam_init(params)
    losses, first_grad = [], None
    for k, rec in enumerate(st.probes.train_log[tid][:CHECK_UPDATES]):
        # update k trains rows decoded at versions 0..k
        rows = batch_rows(rec, model, lambda v: versions[min(v, k)])
        loss, grads, params, opt = grpo_step(model, params, opt, rows, group,
                                             hp, keep=keep_rows)
        versions.append(params)
        losses.append(loss)
        if first_grad is None:
            first_grad = grads
    return {"tid": tid, "losses": losses, "first_grad": first_grad,
            "final": params}


def train_readings(st, ref: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, float]:
    """The three trained numbers of `other` (the program's, or a control's or
    fault's run of ``follow``) against the reference's run."""
    tid = other["tid"]
    idx = int(tid[1:])
    g_ref = _norms(ref["first_grad"])
    med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    g_oth = _norms(other["first_grad"])
    d_ref = _norms(_sub(ref["final"], st.adapters0[idx]))
    d_oth = _norms(_sub(other["final"], st.adapters0[idx]))
    grad_gap, gw = leaf_gap(g_oth, g_ref, keep)
    upd_gap, uw = leaf_gap(d_oth, d_ref, keep)
    loss_gap = max(abs(a - b) for a, b in zip(other["losses"], ref["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": upd_gap,
            "leaves": float(len(keep)), "leaves_out": float(len(g_ref) - len(keep))}


def program_run(st, tid: str, b1: float = 0.9) -> Dict[str, Any]:
    """The program's three updates as ``train_readings`` reads them."""
    log = st.probes.train_log[tid][:3]
    m1 = _lora(log[0].opt_state["m"])
    first = {t: {k: v / (1 - b1) for k, v in ab.items()} for t, ab in m1.items()}
    return {"tid": tid, "losses": [float(r.metrics["loss"]) for r in log],
            "first_grad": first, "final": _lora(log[2].adapters)}


def train_max(st, refs: Dict[str, Dict[str, Any]],
              others: Dict[str, Dict[str, Any]]) -> Dict[str, float]:
    """The trained numbers of each check tenant, the widest over them."""
    out: Dict[str, float] = {}
    for tid, ref in refs.items():
        r = train_readings(st, ref, others[tid])
        for k, v in r.items():
            out[k] = v + out.get(k, 0.0) if k.startswith("leaves") else max(
                v, out.get(k, 0.0))
    return out


def check(st, limits: Dict[str, Any], log=print) -> Tuple[bool, Dict[str, float], List[str]]:
    """Runs the reference; returns (correct, readings, reasons)."""
    t0 = time.monotonic()
    model = ref_model(st)
    readings: Dict[str, float] = {}
    why: List[str] = []
    tids = check_tenants(st)
    if not tids:
        why.append("no tenant made three updates")
    rows = pick_served(st, tids)
    if not any(r.greedy for r in rows):
        why.append("no greedy row finished")
    if not any(not r.greedy for r in rows):
        why.append("no sampled row finished")
    readings.update(served_readings(st, model, rows))
    refs = {t: follow(st, model, t) for t in tids}
    readings.update(train_max(st, refs, {t: program_run(st, t) for t in tids}))
    readings["unmatched_rows"] = float(st.probes.unmatched_rows)
    readings["check_s"] = time.monotonic() - t0
    for name, lim in limits.items():
        if "limit" not in lim:
            continue
        v = readings.get(name)
        if v is None or not np.isfinite(v) or v > lim["limit"]:
            why.append(f"{name} {v} over its limit {lim['limit']}")
    return not why, readings, why
