#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: print the card's name and power limit; build the kernels from
     the sources in ``ray_tpu_torch/ops/csrc`` (one nvcc per source, in
     parallel);
  2. kernels against their plain versions on the card, in bf16 and f32, at
     the shapes the main path gives them and a few more;
  3. kernel, plain-version, bound and library (SDPA) times at the engine's
     prefill shapes;
  4. ``llama.apply`` at ``__graft_entry__.entry()``'s config: logits through
     the kernel against logits through the plain attention;
  5. the serving engine at full width (the serving model of ``bench.py``):
     every request streams its full token count, the kernel's launch
     counter grew during the run, and one prefill's first-token logits
     through the kernel agree with the same prefill through the plain
     attention.
The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
where CUDA is missing or any phase fails.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without tensor
# cores, and HBM3 bandwidth.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under the profiler; returns the
    device-side events' (name, total ms, count), largest first.  Only
    device events: the aten ops that launched them carry the same time
    again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: the sum of its kernels' times, free
    of the host's launch overhead that a tight event-timed loop of small
    calls measures instead."""
    return sum(t for _, t, _ in device_events(fn, iters)) / iters


def attention_work(bh, sq, sk, d, causal, itemsize):
    """(operations, bytes) one flash-forward call needs: 4*d per unmasked
    (query, key) pair; q, k, v read once, out and lse written once."""
    if causal:
        pairs = sum(min(r + 1, sk) for r in range(sq))
    else:
        pairs = sq * sk
    ops = 4 * d * pairs * bh
    nbytes = (2 * bh * sq * d + 2 * bh * sk * d) * itemsize + bh * sq * 4
    return ops, nbytes


def bound_ms(ops, nbytes, dtype_name):
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def make_qkv(gen, b, h, hkv, sq, sk, d, dtype):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b * h, sq, d), rnd(b * hkv, sk, d), rnd(b * hkv, sk, d)


def out_tolerance(dtype, ref):
    """f32: the kernel and the plain version sum in other orders, 2e-5.
    bf16: both compute in f32 from the same bf16 inputs and round the
    output once; allow 2 bf16 ulps at the largest output magnitude."""
    import torch

    if dtype == torch.float32:
        return 2e-5
    return 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))


LSE_TOL = 1e-4  # lse is f32 in both; only the summation order differs
# bf16 forwards through the kernel and through the plain attention round
# their attention outputs independently; the 1-ulp differences pass
# through every later layer.  Logit differences are held to 5% of the
# largest logit.
APPLY_TOL = 0.05


def check_kernels(report):
    import torch

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (32, 128, 1024):  # the engine's prefill buckets
            cases.append(("engine_prefill", 1, 12, 12, s, s, 64, True, dtype))
        cases.append(("entry", 2, 8, 4, 256, 256, 64, True, dtype))
        for causal in (True, False):
            cases.append(("llama3_8b", 1, 32, 8, 2048, 2048, 128, causal,
                          dtype))
        cases.append(("ragged", 1, 4, 2, 100, 100, 32, True, dtype))
        cases.append(("ragged", 2, 4, 1, 77, 130, 64, False, dtype))
    rows = []
    for name, b, h, hkv, sq, sk, d, causal, dtype in cases:
        q, k, v = make_qkv(gen, b, h, hkv, sq, sk, d, dtype)
        scale = 1.0 / math.sqrt(d)
        out, lse = attention.flash_forward(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = attention.reference_attention(q, k, v, causal,
                                                         scale)
        err_out = float((out.float() - ref_out.float()).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        tol = out_tolerance(dtype, ref_out)
        ok = (err_out <= tol and err_lse <= LSE_TOL
              and bool(torch.isfinite(out.float()).all()))
        row = {"case": name, "b": b, "h": h, "hkv": hkv, "sq": sq, "sk": sk,
               "d": d, "causal": causal, "dtype": str(dtype)[6:],
               "err_out": err_out, "tol_out": tol, "err_lse": err_lse,
               "tol_lse": LSE_TOL, "ok": ok}
        rows.append(row)
        print(f"kernel-vs-plain {name:15s} b{b} h{h}/{hkv} s{sq}x{sk} d{d} "
              f"causal={causal!s:5s} {row['dtype']:8s} out err "
              f"{err_out:.3e} (tol {tol:.3e})  lse err {err_lse:.3e} "
              f"(tol {LSE_TOL:.0e})  {'ok' if ok else 'FAIL'}", flush=True)
    report["kernel_checks"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"flash_fwd disagrees with its plain version: {bad}")
    # no silent autograd: inputs that need a gradient are refused on CUDA
    q, k, v = make_qkv(gen, 1, 2, 2, 64, 64, 64, torch.bfloat16)
    try:
        attention.flash_forward(q.requires_grad_(), k, v, True, 0.125)
    except NotImplementedError:
        pass
    else:
        raise SystemExit("flash_forward accepted requires_grad inputs")


def time_kernels(report):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for s in (32, 128, 1024):
        bh, d, dtype = 12, 64, torch.bfloat16
        q, k, v = make_qkv(gen, 1, bh, bh, s, s, d, dtype)
        scale = 1.0 / math.sqrt(d)
        q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
        calls = {
            "kernel": lambda: attention.flash_forward(q, k, v, True, scale),
            "plain": lambda: attention.reference_attention(q, k, v, True,
                                                           scale),
            "sdpa": lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale),
        }
        dev = {n: device_ms(fn) for n, fn in calls.items()}
        wall = {n: time_ms(fn) for n, fn in calls.items()}
        ops, nbytes = attention_work(bh, s, s, d, True, 2)
        bms, by = bound_ms(ops, nbytes, "bfloat16")
        out, _ = attention.flash_forward(q, k, v, True, scale)
        ref, _ = attention.reference_attention(q, k, v, True, scale)
        rows.append({"seq": s, "bh": bh, "d": d, "dtype": "bfloat16",
                     "causal": True, "ms": dev["kernel"],
                     "plain_ms": dev["plain"], "library_ms": dev["sdpa"],
                     "wall_ms": wall, "bound_ms": bms, "bound_by": by,
                     "ops": ops, "bytes": nbytes,
                     "max_abs_err": float((out.float() - ref.float())
                                          .abs().max())})
        print(f"time flash_fwd bh{bh} s{s} d{d} bf16 causal, device ms per "
              f"call: kernel {dev['kernel']:.4f}, plain {dev['plain']:.4f}, "
              f"sdpa {dev['sdpa']:.4f}, bound {bms:.5f} ({by}); wall ms per "
              f"call in a loop: kernel {wall['kernel']:.4f}, plain "
              f"{wall['plain']:.4f}, sdpa {wall['sdpa']:.4f}", flush=True)
    report["kernel_times"] = rows
    return rows


def check_apply(report):
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention

    # __graft_entry__.entry()'s config and input shape
    cfg = llama.LlamaConfig(
        vocab_size=32000, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
        d_ff=1536, max_seq_len=1024, remat=False)
    gen = torch.Generator(device="cuda").manual_seed(2)
    state = llama.init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda")
    with torch.inference_mode():
        before = attention.flash_forward.launches
        flash = llama.apply(state, tokens, cfg)
        launched = attention.flash_forward.launches - before
        plain = llama.apply(state, tokens, cfg, attn_impl="plain")
    err = float((flash - plain).abs().max())
    scale = float(plain.abs().max())
    tol = APPLY_TOL * max(1.0, scale)
    agree = float((flash.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"llama.apply entry config bf16: logits max abs diff {err:.4e} "
          f"(tol {tol:.3e}, max |logit| {scale:.3f}), argmax agreement "
          f"{agree:.4f}, kernel launches {launched}", flush=True)
    report["apply"] = {"err": err, "tol": tol, "max_logit": scale,
                       "argmax_agree": agree, "launches": launched}
    if not (err <= tol and bool(torch.isfinite(flash).all())
            and launched == cfg.n_layers):
        raise SystemExit("llama.apply through the kernel disagrees")


def run_engine(report):
    import torch

    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, \
        SamplingParams
    from ray_tpu_torch.llm.paged_cache import CacheConfig, init_cache
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention

    # bench.py's serving model (bench.py:85-90) and engine config
    cfg = llama.LlamaConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, max_seq_len=1024, remat=False)
    state = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    ecfg = EngineConfig(max_slots=16, num_pages=512, page_size=16,
                        max_seq_len=1024)
    engine = LLMEngine(state, cfg, ecfg)
    del state
    kv_bytes = 2 * engine.cache_k.numel() * engine.cache_k.element_size()
    vocab = cfg.vocab_size

    def prompt(i, n):
        return [(7 * i + 13 * j + 1) % vocab for j in range(n)]

    def drain(req, timeout=300):
        toks = []
        while True:
            item = req.out_queue.get(timeout=timeout)
            if item is None:
                return toks
            if isinstance(item, Exception):
                raise item
            toks.append(item)

    engine.start()
    try:
        # warm-up: the 128 and 1024 buckets, the burst and the sampled step
        engine.generate(prompt(1000, 100), SamplingParams(max_tokens=8))
        engine.generate(prompt(1001, 600), SamplingParams(max_tokens=4))
        engine.generate(prompt(1002, 128), SamplingParams(
            max_tokens=4, temperature=0.8, seed=1))
        torch.cuda.synchronize()

        attention.flash_forward.launches = 0
        stats0 = engine.stats()
        ttfts = []
        for i in range(3):  # unloaded: one request at a time
            r = engine.submit(prompt(2000 + i, 128),
                              SamplingParams(max_tokens=4))
            if len(drain(r)) != 4:
                raise SystemExit("unloaded request streamed short")
            ttfts.append(r.first_token_at - r.submitted_at)

        t0 = time.monotonic()
        reqs = [(engine.submit(prompt(i, 128), SamplingParams(
            max_tokens=32)), 32) for i in range(16)]
        reqs.append((engine.submit(prompt(100, 600), SamplingParams(
            max_tokens=32)), 32))
        reqs.append((engine.submit(prompt(101, 128), SamplingParams(
            max_tokens=32, temperature=0.8, seed=7)), 32))
        # shares request 0's first 7 pages: admitted after request 0
        # registered its blocks, so the prefix-cache suffix prefill runs
        while reqs[0][0].first_token_at is None:
            time.sleep(0.001)
        shared = prompt(0, 128)[:112] + prompt(102, 16)
        reqs.append((engine.submit(shared, SamplingParams(max_tokens=32)),
                     32))
        outs = [drain(r) for r, _ in reqs]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = attention.flash_forward.launches
        stats1 = engine.stats()
    finally:
        engine.stop()

    short = [(i, len(o), want) for i, ((_, want), o)
             in enumerate(zip(reqs, outs)) if len(o) != want]
    if short:
        raise SystemExit(f"requests streamed short: {short}")
    if any(not all(0 <= t < vocab for t in o) for o in outs):
        raise SystemExit("token out of vocabulary range")
    n_tokens = sum(len(o) for o in outs)
    hit = (stats1["prefix_cache"]["hit_tokens"]
           - stats0["prefix_cache"]["hit_tokens"])
    prefills = stats1["prefills"] - stats0["prefills"]
    if launches <= 0:
        raise SystemExit("the engine never launched the flash kernel")
    if hit <= 0:
        raise SystemExit("the prefix-cache path did not run")

    # one prefill through the kernel vs the plain attention, first token
    ccfg = CacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, num_pages=16, page_size=16,
                       dtype=cfg.dtype)
    toks = torch.tensor(prompt(3000, 128), device="cuda")
    pos = torch.arange(128, device="cuda")
    rows, slots = 1 + pos // 16, pos % 16
    logits = {}
    with torch.inference_mode():
        for impl in ("flash", "plain"):
            ck, cv = init_cache(ccfg, "cuda")
            logits[impl] = lm.prefill(engine.state, toks, ck, cv, rows, 128,
                                      slots, cfg, attn_impl=impl)
    err = float((logits["flash"] - logits["plain"]).abs().max())
    scale = float(logits["plain"].abs().max())
    tol = APPLY_TOL * max(1.0, scale)
    same_first = int(logits["flash"].argmax()) == int(
        logits["plain"].argmax())

    res = {"requests": len(reqs), "tokens": n_tokens, "wall_s": wall,
           "output_tok_s": n_tokens / wall,
           "ttft_unloaded_ms": sorted(t * 1e3 for t in ttfts),
           "flash_launches": launches, "prefills": prefills,
           "launches_per_prefill": launches / max(prefills, 1),
           "prefix_hit_tokens": hit,
           "preempted": stats1["preempted"] - stats0["preempted"],
           "kv_cache_bytes": kv_bytes,
           "first_token_logit_err": err, "first_token_logit_tol": tol,
           "first_token_same": same_first,
           "p50_prefill_ms": stats1["p50_prefill_ms"]}
    report["engine"] = res
    print(f"engine (this card): {len(reqs)} requests, {n_tokens} tokens in "
          f"{wall:.3f} s = {n_tokens / wall:.1f} output tok/s; unloaded "
          f"TTFT p50 {sorted(ttfts)[1] * 1e3:.2f} ms; flash launches "
          f"{launches} over {prefills} prefills; prefix hit tokens {hit}; "
          f"KV cache {kv_bytes / 2**20:.0f} MiB", flush=True)
    print(f"engine prefill first-token logits kernel vs plain: max abs "
          f"diff {err:.4e} (tol {tol:.3e}), same first token {same_first}",
          flush=True)
    if not (err <= tol and bool(torch.isfinite(logits["flash"]).all())):
        raise SystemExit("prefill through the kernel disagrees")
    with torch.inference_mode():
        report["steps"] = profile_steps(engine, cfg, ccfg, toks, rows, slots)
    return launches


def profile_steps(engine, cfg, ccfg, toks, rows, slots):
    """Where one bucket-128 prefill and one 16-slot greedy decode step spend
    their time: CUDA-event wall time, device time summed by the profiler,
    and the kernels that take most of it.  Outside the counted run."""
    import torch

    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.llm.paged_cache import init_cache

    ck, cv = init_cache(ccfg, "cuda")
    B, P = engine.cfg.max_slots, engine.max_pages_per_seq
    tables = torch.zeros((B, P), dtype=torch.long, device="cuda")
    tables[:, :8] = torch.arange(1, 9, device="cuda")
    positions = torch.full((B,), 128, dtype=torch.long, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    dtok = toks[:B].clone()
    steps = {
        "prefill_128": lambda: lm.prefill(engine.state, toks, ck, cv, rows,
                                          128, slots, cfg),
        "decode_greedy_16": lambda: lm.decode_step_greedy(
            engine.state, dtok, ck, cv, tables, positions, active, cfg),
    }
    out = {}
    for name, fn in steps.items():
        ms = time_ms(fn, iters=10)
        rows_ = device_events(fn)
        busy = sum(r[1] for r in rows_)
        out[name] = {"ms": ms, "device_ms": busy,
                     "top": [{"kernel": k[:90], "ms": t, "count": c}
                             for k, t, c in rows_[:8]]}
        print(f"step {name}: {ms:.3f} ms per call, device busy "
              f"{busy:.3f} ms; top: " + "; ".join(
                  f"{k[:40]} {t:.3f} ms x{c}" for k, t, c in rows_[:4]),
              flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"card": card_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(f"card: {report['card']}", flush=True)
    t0 = time.monotonic()
    paths = _build.build(["flash_fwd"])
    report["build_s"] = time.monotonic() - t0
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        info = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log.exists() else []
        report[f"ptxas_{name}"] = info
        print(f"built {name} in {report['build_s']:.1f} s: "
              + " | ".join(info), flush=True)

    check_kernels(report)
    times = time_kernels(report)
    check_apply(report)
    launches = run_engine(report)

    main_row = next(r for r in times if r["seq"] == 128)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:121",
        "launches": launches, "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    report["kernels"] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
