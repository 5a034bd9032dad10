#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --profile DIR   # also profile one served round

Phases (any failure raises and exits non-zero; nothing is caught):
 1. device: requires a CUDA card and prints nvidia-smi's name and power limit;
 2. build: compiles every kernel of the serving path from csrc/ (sm_90a);
 3. kernels: holds each hand-written kernel against its plain PyTorch version
    at the serving path's shapes, and times kernel, plain version, one
    library call, and the card's bound for the same work;
 4. serve: RolloutEngine.generate at qwen3-0.6b's full size in bf16 (28
    layers, d=1024, V=151936) for 4 tenants x 4 gsm8k requests with
    random-b adapters; the kernels' launch counts must match the steps run;
 5. check: teacher-forces 4 served rows through forward_seq in fp32 on the
    card (kernels) and on the CPU (plain versions) and compares the logprobs.
It prints the kernels' JSON line and the card's line before the last, and as
the last line {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, no sparsity
ARCH = "qwen3-0.6b"
TENANTS, PER_TENANT, MAX_NEW, MAX_LEN = 4, 4, 32, 256
B_SCALE = 0.02          # adapter b ~ N(0, B_SCALE^2): a delta of ~10% of a projection
TF_ROWS = 4             # rows teacher-forced in phase 5
TF_TOL = 1e-3           # fp32 logprobs, card (kernels) vs CPU (plain versions)


def log(msg):
    print(msg, flush=True)


def bench_ms(fn, arg_sets, iters=40, warmup=3):
    """Mean milliseconds per eager call of fn(*args), host included, cycling
    through arg_sets (several copies of the inputs, so that their total
    exceeds the 50 MB L2 and each call finds its inputs cold, as each layer
    does in decode). Small kernels are host-bound here: this is what the
    eager main path pays per call."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters=40):
    """Mean device milliseconds of fn(*args): `iters` calls, cycling through
    arg_sets, captured in one CUDA graph and timed by replaying it, so that
    no host (Python wrapper) time sits between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def copies_for(nbytes, floor=2):
    """How many input copies exceed the 50 MB L2 twice over."""
    return max(floor, int(100e6 // max(nbytes, 1)) + 1)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_gqa_decode(torch, gqa, ref, g, serve_pos_hi):
    B, H, KVH, hd = 16, 16, 8, 128
    cases = []
    for S in (256, 1000):
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
            for cap, win in ((0.0, 0), (50.0, 0), (0.0, 24)):
                main = S == 256 and dt == torch.bfloat16 and not cap and not win
                hi = serve_pos_hi if main else S
                pos = torch.randint(1, hi + 1, (B,), generator=g, device="cuda",
                                    dtype=torch.int32)
                pos[0], pos[-1] = 1, hi
                q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
                elt = q.element_size()
                n_copy = copies_for(2 * B * S * KVH * hd * elt)
                caches = [(torch.randn(B, S, KVH, hd, generator=g, device="cuda").to(dt),
                           torch.randn(B, S, KVH, hd, generator=g, device="cuda").to(dt))
                          for _ in range(n_copy)]
                ck, cv = caches[0]
                got = gqa.gqa_decode(q, ck, cv, pos, softcap=cap, window=win)
                want = ref.gqa_decode_ref(q, ck, cv, pos, softcap=cap, window=win)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                ok = bool((err <= tol + tol * want.float().abs()).all())
                if not ok:
                    raise AssertionError(f"gqa_decode S={S} {dt} cap={cap} win={win}: "
                                         f"max err {err.max().item():.3e} > tol {tol}")
                sets = [(q, k, v, pos) for k, v in caches]

                def kern(q, k, v, p):
                    return gqa.gqa_decode(q, k, v, p, softcap=cap, window=win)

                def plain(q, k, v, p):
                    return ref.gqa_decode_ref(q, k, v, p, softcap=cap, window=win)
                k_ms, p_ms = device_ms(kern, sets), device_ms(plain, sets)
                call_ms = bench_ms(kern, sets)
                lib_ms = None
                if not cap:
                    idx = torch.arange(S, device="cuda")
                    p64 = pos.long()[:, None]
                    valid = idx[None, :] < p64
                    if win:
                        valid &= (p64 - 1 - idx[None, :]) < win
                    mask = valid[:, None, None, :]

                    def sdpa(q, k, v, p, mask=mask):
                        return torch.nn.functional.scaled_dot_product_attention(
                            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                            attn_mask=mask, enable_gqa=True)
                    lib_ms = device_ms(sdpa, sets)
                lo = (pos.long() - win).clamp(min=0) if win else torch.zeros_like(pos.long())
                keys = int((pos.long().clamp(max=S) - lo).sum())
                nbytes = (2 * q.numel() * elt + 2 * keys * KVH * hd * elt + 4 * B)
                flops = 4 * keys * (H // KVH) * KVH * hd
                b_ms, b_by = bound_ms(nbytes, flops, str(dt).split(".")[1])
                cases.append(dict(S=S, dtype=str(dt).split(".")[1], softcap=cap,
                                  window=win, pos_max=hi, main=main,
                                  max_abs_err=float(err.max()), tol=tol,
                                  ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by, call_ms=call_ms))
                log(f"  gqa_decode S={S:4d} {cases[-1]['dtype']:8s} cap={cap:4.0f} "
                    f"win={win:2d}: err {cases[-1]['max_abs_err']:.2e} (tol {tol}) "
                    f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
                    f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms "
                    f"bound {b_ms:.4f} ms ({b_by}); eager call {call_ms:.4f} ms")
    return cases


def check_sgmv(torch, sgmv, ref, g, S_p):
    T, r = 4, 16
    pairs = [(1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
             (1024, 6144), (3072, 1024)]        # q, k, v, o, mlp_in, mlp_out
    cases = []
    for R in (TENANTS * PER_TENANT, TENANTS * PER_TENANT * S_p):
        per_tenant_rows = R // T
        ids = torch.arange(T, device="cuda", dtype=torch.int32).repeat_interleave(
            per_tenant_rows)
        for (d, dout), xdt in [(p, torch.bfloat16) for p in pairs] + \
                [((1024, 6144), torch.float32)]:
            x = torch.randn(R, d, generator=g, device="cuda").to(xdt)
            n_copy = copies_for(4 * T * r * (d + dout))
            ads = [(torch.randn(T, d, r, generator=g, device="cuda") / d ** 0.5,
                    torch.randn(T, r, dout, generator=g, device="cuda") * 0.1)
                   for _ in range(n_copy)]
            a, b = ads[0]
            got = sgmv.sgmv(x, a, b, ids)
            want = ref.sgmv_ref(x, a, b, ids)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol_a, tol_r = 1e-4, 1e-5
            if not bool((err <= tol_a + tol_r * want.abs()).all()):
                raise AssertionError(f"sgmv R={R} d={d} dout={dout} {xdt}: max err "
                                     f"{err.max().item():.3e}")
            sets = [(x, a_, b_, ids) for a_, b_ in ads]
            k_ms, p_ms = device_ms(sgmv.sgmv, sets), device_ms(ref.sgmv_ref, sets)
            call_ms = bench_ms(sgmv.sgmv, sets)

            def gathered_bmm(x, a, b, ids):
                il = ids.long()
                return torch.bmm(torch.bmm(x.float()[:, None, :], a[il]), b[il])[:, 0]
            lib_ms = device_ms(gathered_bmm, sets)
            n_t = int(torch.unique(ids).numel())
            nbytes = (x.numel() * x.element_size() + n_t * (d * r + r * dout) * 4
                      + 4 * R + 4 * R * dout)
            flops = 2 * R * (d * r + r * dout)
            b_ms, b_by = bound_ms(nbytes, flops, "float32")
            main = R == TENANTS * PER_TENANT and (d, dout) == (1024, 6144) \
                and xdt == torch.bfloat16
            cases.append(dict(R=R, d=d, dout=dout, r=r, T=T,
                              x_dtype=str(xdt).split(".")[1], main=main,
                              max_abs_err=float(err.max()), tol=tol_a,
                              ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by, call_ms=call_ms))
            log(f"  sgmv R={R:4d} {d:4d}->{dout:4d} x {cases[-1]['x_dtype']:8s}: "
                f"err {cases[-1]['max_abs_err']:.2e} kernel {k_ms:.4f} ms plain "
                f"{p_ms:.4f} ms library {lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}); "
                f"eager call {call_ms:.4f} ms")
    return cases


def kernel_entry(name, source, replaces, cases, launches, extra):
    main = next(c for c in cases if c["main"])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max(c["max_abs_err"] for c in cases),
                tolerance=main["tol"], ms=main["ms"], kernel_ms=main["ms"],
                call_ms=main["call_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                shape={k: v for k, v in main.items()
                       if k not in ("ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "tol", "main",
                                    "call_ms")},
                **extra, cases=cases)


# ---------------------------------------------------------------------------
# phase 5: teacher-forced fp32 check, card vs CPU
# ---------------------------------------------------------------------------

def teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, device):
    """Per-token logprobs of each row's generated tokens, teacher-forced
    through forward_seq in fp32 on `device`."""
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.rollout.prefill import _bucket_len

    def fp32(tree):
        return M.tree_map(lambda t: t.to(device=device, dtype=torch.float32), tree)

    p32 = fp32(params)
    stacked = stack_adapters([fp32(a) for a in adapters])
    S = _bucket_len(max(len(r["tokens"]) for r, _ in rows))
    tokens = torch.zeros((len(rows), S), dtype=torch.int32)
    for i, (r, _) in enumerate(rows):
        tokens[i, :len(r["tokens"])] = torch.tensor(r["tokens"])
    ids = torch.tensor([a for _, a in rows], dtype=torch.int32, device=device)
    with torch.inference_mode():
        h, _, _ = M.forward_seq(p32, tokens.to(device), cfg,
                                batched_ctx(stacked, ids, cfg))
        logp = torch.log_softmax(M.lm_logits(h, p32, cfg), dim=-1)
    out = []
    for i, (r, _) in enumerate(rows):
        p0 = r["prompt_len"]
        tgt = torch.tensor(r["tokens"][p0:], device=device).long()
        pos = torch.arange(p0 - 1, len(r["tokens"]) - 1, device=device)
        out.append(logp[i, pos, tgt].cpu().double())
    return out


def profile_serve(torch, cfg, params, adapters, out_dir):
    """One short served round under torch.profiler: device time by kernel,
    and the device's busy share of the round's wall time. The full table
    goes to out_dir/serve_profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    from repro_torch.rollout.engine import RolloutEngine

    eng = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=2, device="cuda")
    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=8, seed=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, st = eng.generate(reqs, adapters)
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue              # host ops; their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = {}
    for us, _, key in rows:
        g = _kernel_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))), reverse=True)
    lines = [f"{us / 1e3:10.3f} ms {n:7d} calls  {key}" for us, n, key in rows]
    host_lines = [f"{us / 1e3:10.3f} ms {n:7d} calls  {key}" for us, n, key in host[:40]]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "serve_profile.txt").write_text(
        f"decode steps {st.decode_steps}, wall {st.wall_seconds:.4f} s, device busy "
        f"{busy_s:.4f} s\n\n-- device time by group (ms)\n"
        + "\n".join(f"{v:10.3f}  {k}" for k, v in sorted(groups.items(),
                                                         key=lambda kv: -kv[1]))
        + "\n\n-- device time by kernel\n" + "\n".join(lines)
        + "\n\n-- host self time by op (top 40)\n" + "\n".join(host_lines) + "\n")
    log(f"[4b profile] {st.decode_steps} decode steps, wall {st.wall_seconds:.4f} s "
        f"(under the profiler), device busy {busy_s:.4f} s = "
        f"{100 * busy_s / st.wall_seconds:.1f}%; device ms by group: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                                      key=lambda kv: -kv[1])))
    for line in lines[:12]:
        log("  " + line[:150])


def _kernel_group(name):
    """Coarse owner of a device kernel, for the profile's breakdown."""
    if "sgmv" in name:
        return "sgmv"
    if "gqa_decode" in name:
        return "gqa_decode"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "nvjet" in name or "gemm" in name or "Gemm" in name:
        return "matmul"
    if "<long" in name or "Bitwise" in name or "shift" in name:
        return "int64 elementwise (sampler)"
    return "other elementwise / reductions"


def main(argv):
    profile_dir = (Path(argv[argv.index("--profile") + 1])
                   if "--profile" in argv else None)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.kernels import sgmv
    from repro_torch import models as M
    from repro_torch.launch.serve import (make_adapters, make_requests,
                                          serve_config)
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.rollout.prefill import _bucket_len

    t_all = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()}")

    secs = _build.build_all()
    log(f"[2 build] kernels built in {secs:.2f} s")
    for name, text in _build.build_logs().items():
        regs = [int(w.split()[0]) for w in text.split("Used ")[1:]]
        spill = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                    for line in text.splitlines() if "bytes spill stores" in line)
        log(f"  {name}: {len(regs)} kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)}, spill stores {spill} bytes in all"
            if regs else f"  {name}: {text.strip()[:200]}")

    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=MAX_NEW, seed=0)
    S_p = _bucket_len(max(len(r.prompt) for r in reqs))
    serve_pos_hi = S_p + MAX_NEW
    g = torch.Generator(device="cuda").manual_seed(1234)
    log("[3 kernels] each kernel against its plain version")
    gqa_cases = check_gqa_decode(torch, gqa, ref, g, serve_pos_hi)
    sgmv_cases = check_sgmv(torch, sgmv, ref, g, S_p)

    # -- phase 4: serve ---------------------------------------------------
    cfg = serve_config(ARCH, reduce=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, "cuda")
    adapters = make_adapters(cfg, TENANTS, seed=0, device="cuda", b_scale=B_SCALE)
    warm = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=1, device="cuda")
    warm.generate(make_requests(TENANTS, 1, max_new_tokens=2, seed=1), adapters)
    engine = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gqa.LAUNCHES.n = 0
    sgmv.LAUNCHES.n = 0
    results, stats = engine.generate(reqs, adapters)
    n_gqa, n_sgmv = gqa.LAUNCHES.n, sgmv.LAUNCHES.n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = stats.decode_steps
    want_gqa = cfg.num_layers * steps
    want_sgmv = 6 * cfg.num_layers * (steps + 1)
    if (n_gqa, n_sgmv) != (want_gqa, want_sgmv):
        raise AssertionError(f"launch counts gqa_decode {n_gqa} (want {want_gqa}), "
                             f"sgmv {n_sgmv} (want {want_sgmv})")
    B = len(reqs)
    for r, q in zip(results, reqs):
        gen_toks = r["tokens"][r["prompt_len"]:]
        if not (1 <= len(gen_toks) <= q.max_new_tokens):
            raise AssertionError(f"row generated {len(gen_toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in gen_toks):
            raise AssertionError("token id outside the vocabulary")
        if not all(np.isfinite(lp) and lp <= 0 for lp in r["gen_logprobs"]):
            raise AssertionError("non-finite or positive logprob")
    decode_tokens = stats.tokens_generated - B
    tok_s = decode_tokens / stats.decode_seconds
    log(f"[4 serve] {ARCH} full size bf16 ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"V={cfg.vocab_size}), {TENANTS} tenants x {PER_TENANT} requests, "
        f"prompt bucket {S_p}, max_len {MAX_LEN}: {steps} decode steps, "
        f"{decode_tokens} decode tokens in {stats.decode_seconds:.3f} s = "
        f"{tok_s:.1f} tok/s ({1e3 * stats.decode_seconds / steps:.2f} ms/step), "
        f"prefill {stats.prefill_seconds:.4f} s, peak memory {peak_gib:.2f} GiB, "
        f"launches gqa_decode {n_gqa} sgmv {n_sgmv} (= {cfg.num_layers} x {steps}, "
        f"6 x {cfg.num_layers} x {steps + 1}) on {card}")

    if profile_dir is not None:
        profile_serve(torch, cfg, params, adapters, profile_dir)

    # -- phase 5: teacher-forced fp32, card (kernels) vs CPU (plain) --------
    rows = [(results[i], reqs[i].adapter_index)
            for i in range(0, B, B // TF_ROWS)][:TF_ROWS]
    n_sgmv0 = sgmv.LAUNCHES.n
    on_card = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cuda")
    if sgmv.LAUNCHES.n - n_sgmv0 != 6 * cfg.num_layers:
        raise AssertionError("the fp32 card forward did not run the sgmv kernel")
    on_cpu = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cpu")
    tf_err = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    served = [torch.tensor(r["gen_logprobs"], dtype=torch.float64) for r, _ in rows]
    bf16_dev = max(float((a - s).abs().max()) for a, s in zip(on_card, served))
    log(f"[5 check] teacher-forced fp32 logprobs of {len(rows)} rows "
        f"({sum(len(a) for a in on_card)} tokens): card vs CPU max abs diff "
        f"{tf_err:.3e} (tol {TF_TOL}); served bf16 vs fp32 max abs diff "
        f"{bf16_dev:.3e}")
    if not tf_err <= TF_TOL:
        raise AssertionError(f"fp32 card vs CPU logprobs differ by {tf_err}")

    print(json.dumps({"serve": dict(
        arch=ARCH, decode_tokens_per_s=tok_s, decode_steps=steps,
        decode_s=stats.decode_seconds, prefill_s=stats.prefill_seconds,
        peak_mem_gib=peak_gib, tf_max_abs_diff=tf_err,
        seconds=time.monotonic() - t_all, card=card)}), flush=True)
    print(json.dumps({"kernels": [
        kernel_entry("gqa_decode", "src/repro_torch/kernels/csrc/gqa_decode.cu",
                     "src/repro/kernels/gqa_decode.py:71", gqa_cases, n_gqa,
                     dict(launches_per_decode_step=cfg.num_layers)),
        kernel_entry("sgmv", "src/repro_torch/kernels/csrc/sgmv.cu",
                     "src/repro/kernels/sgmv.py:64", sgmv_cases, n_sgmv,
                     dict(launches_per_decode_step=6 * cfg.num_layers,
                          cuda_launches_per_call=2)),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
