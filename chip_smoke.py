#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: print the card's name and power limit; build the kernels from
     the sources in ``ray_tpu_torch/ops/csrc`` (one nvcc per source, in
     parallel) and print ptxas's registers and spills for each
     tensor-core kernel;
  2. kernels against their plain versions on the card, in bf16 (the
     tensor-core forward, dK/dV and dQ kernels) and f32 (the scalar
     kernels), at the shapes the main paths give them (the forward at
     every prefill bucket of ``EngineConfig``) and a few more, and
     gradients through the ``FlashAttention`` autograd Function against
     autograd through the plain attention;
  3. kernel, plain-version, bound and library (SDPA) times at the engine's
     prefill shapes and at the trainer's attention shape; the trainer-shape
     times are read twice in the run, before the engine and after the
     trainers;
  4. ``llama.apply`` at ``__graft_entry__.entry()``'s config: logits through
     the kernel against logits through the plain attention;
  5. the serving engine at full width (the serving model of ``bench.py``):
     every request streams its full token count, the forward kernel's
     launch counter grew during the run, and one prefill's first-token
     logits through the kernel agree with the same prefill through the
     plain attention, and a profiled bucket-128 prefill runs the
     tensor-core forward kernel once per layer and no scalar kernel;
  6. the serving front ends at the serving width (``run_frontends``): the
     P/D handoff over the host relay (token ids equal to a fresh single
     engine's, injected pages equal to the prefill engine's), the KV tier
     (a sealed spine prehydrated into a fresh engine with equal pages, the
     P/D tier handoff, a torn blob's typed fallback), ``LLMServer`` behind
     ``OpenAIRouter`` (well-formed SSE, streamed and whole responses
     agreeing), the server's output rate and span p50s over two windows
     of ``run_engine``'s 19-request mix sent concurrently, batch
     inference, each request's spans forming one connected tree, the
     engine metrics agreeing with the phase's own counts, and the forward
     kernel launched during the phase; the handoff's extract and inject
     GB/s and seal and hydrate ms;
  7. routed serving at the serving width (``run_serve_bench``): two
     engines behind the pow-2 and prefix-aware routers under
     ``_private/serve_bench.py``'s load-wall ladder (4:128, 16:256,
     32:512: the reference's top rung cut to half its requests), then its
     kill rung with the KV tier off and on: every request of every cell
     completes without an error, the top rung evicts pages under both
     policies, prefix-aware saves prefill tokens, copies COW pages and
     hits more than pow-2, the tier-on kill cell pulls, and the forward
     kernel launches once a layer for every prefill through
     ``lm.prefill``; each rung's req/s, TTFT, evictions
     and hit rate, the reference's acceptance as computed here, and the
     device-busy share of a profiled rerun of the top prefix-aware cell;
  8. the trainer at full width (``bench.py``'s GPT-2 124M train step, batch
     12, seq 1024): the first step's loss and grad norm through the kernels
     agree with the plain attention's, the loss falls on a repeated batch,
     each of the three wrappers launches 12 times a step, and a few steps
     are timed and profiled; the profiled step shows 12 launches of each
     tensor-core kernel (``BF16_KERNELS``) and none of the scalar ones
     (``SCALAR_KERNELS``): the bf16 path runs no scalar kernel;
  9. the user's train loop (``run_torch_trainer``): ``TorchTrainer`` with
     one NCCL GPU worker over ``from_numpy`` int32 token rows, read by
     ``get_dataset_shard("train").iter_torch_batches`` onto the card
     (pinned staging, a side stream, two batches in flight) into phase
     8's GPT-2 124M step, 3 warm-up and 24 timed steps: the loss finite
     and falling, the rows consumed equal to the source's (sha256), the
     worker's first loss equal to this process's own step on the same
     parameters and rows, 12 launches of each kernel a step in the
     worker; its tokens/s against phase 8's, the ``next(batch)`` wait
     p50 / p90, the share of copies done before the step on the batch
     before them ended, and one batch's and a 64 MB block's H2D GB/s,
     pinned and pageable;
 10. the MoE trainer at Mixtral 8x7B's widths cut to one layer, batch 1 x
     seq 4096 (``run_moe_trainer``), between two readings of the kernels
     at its attention shape (32 heads on 8 KV heads, head_dim 128): logits
     and aux against the plain attention (on the tokens both forwards
     route alike), the share of choices dropped by capacity, the first
     step against the plain attention, the loss falling, 2 / 1 / 1
     launches a step, timed and profiled steps with peak memory beside
     its reckoning, and the first step on a world-size-1 NCCL mesh
     through the zigzag dispatch, equal to the step without the mesh;
 11. the Llama-3 8B recipe at Llama-3 8B's widths cut to four layers,
     batch 2 x seq 8192 (``run_llama3_trainer``), between two readings of
     the kernels at its attention shape (32 heads on 8 KV heads, head_dim
     128, seq 8192; the plain versions at 8 heads on 2): first
     ``train_llama3_8b`` through ``DataParallelTrainer``, its controller
     and a spawned worker, with a committed checkpoint of the reckoned
     size (its save GB/s printed; written where there is room, then
     deleted) and steady tokens/s, model TFLOP/s and MFU in the result,
     and a dry-geometry run whose checkpoint is restored onto the card;
     then the same step in this process on a world-size-1 NCCL mesh: the
     first step against the plain attention (one KV head's group at a
     time), the loss falling, 8 / 4 / 4 launches a step, timed and
     profiled steps with peak memory beside its reckoning;
 12. online RLlib (``run_rllib``), the learners on the card and the env
     runners' forward on the CPU: (a) each learner update on the card
     against the same update on the CPU, from the same parameters and a
     recorded batch (``ppo_update`` over PPOConfig's 4 epochs x 4
     minibatches with one permutation generator, ``_impala_update``,
     ``_dqn_update`` with double Q on and off, ``_sac_update``, one
     multi-agent update): parameters, Adam moments and losses within the
     CPU parity tests' tolerance; (b) PPO at ``tests/test_rllib.py``'s
     configuration on ``NumpyCartPole`` (gymnasium's CartPole-v1 in
     numpy) passing that test's gate, with the learner's tensors on
     ``cuda`` and the runners' forward on ``cpu``, each iteration's
     sample s, update ms and env steps/s, and one profiled ``ppo_update``
     (device-busy ms, idle share, launches, top device operations);
     (c) APPO, IMPALA, DQN, SAC and multi-agent PPO at their JAX tests'
     configurations and gates, each with its best return, env steps/s
     and update ms p50; (d) offline RL at the JAX tests' configurations
     and gates: MARWIL (beta 1 and 0) and CQL from expert episodes of
     ``NumpyCartPole``, BC and BC-MARWIL over a numpy ``iter_batches``
     source, the evaluation rollouts' forward on the CPU; (e) DreamerV3
     at ``tests/test_dreamerv3.py``'s learning configuration and gate on
     ``OneHotBanditEnv`` (iterations, updates, update ms p50, the phase's
     seconds; the runner's state and forward on the CPU) and one profiled
     ``_update``.  (a) also holds ``_bc_update`` (beta 0 and 3),
     ``_marwil_update``, ``_cql_update`` and DreamerV3's ``_update``
     (the same Gumbel draws injected on both devices) to the CPU.
The last three lines are the kernels' JSON, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device":
{...}}``.  Exits non-zero, printing no result,
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
import types

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")

# H100 SXM published peaks (dense): bf16 tensor cores, f32 without tensor
# cores, and HBM3 bandwidth.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# The device kernels behind each wrapper, by the name the profiler shows
# (a substring of the demangled name): bf16 runs the tensor-core kernels,
# f32 the scalar ones.  No scalar name may be a substring of a tensor-core
# name.
BF16_KERNELS = {"flash_fwd": "flash_fwd_mma_kernel",
                "flash_bwd_dkv": "flash_bwd_dkv_mma_kernel",
                "flash_bwd_dq": "flash_bwd_dq_mma_kernel"}
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                  "flash_bwd_dq_kernel")
DESIGN = {"flash_fwd": "mma.sync bf16", "flash_bwd_dkv": "mma.sync bf16",
          "flash_bwd_dq": "mma.sync bf16"}


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


PROFILE_ATTEMPTS = 3


def device_events(fn, iters: int = 1, complete=bool):
    """Run ``fn`` ``iters`` times under the profiler; returns the
    device-side events' (name, total ms, count), largest first.  Only
    device events: the aten ops that launched them carry the same time
    again.  A window is whole when every device event came ``iters``
    times over (a whole multiple: a window that lost events, as windows
    late in a run of many threads' launches have, is not) and ``complete``
    accepts its rows (by default: at least one event).  A window that is
    not whole is profiled again, up to ``PROFILE_ATTEMPTS`` windows;
    returns [] when none was."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if all(c % iters == 0 for _, _, c in rows) and complete(rows):
            return sorted(rows, key=lambda r: -r[1])
    return []


def ptxas_report(log: str):
    """{mangled kernel symbol: "registers, static shared memory, spills"}
    from an ``nvcc -Xptxas -v`` log: each line of figures belongs to the
    entry function named last before it."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1].strip("'")
        elif name and ("registers" in line or "spill" in line):
            info = line.split(":", 1)[-1].strip()
            out[name] = f"{out[name]}; {info}" if name in out else info
    return out


def measured(ms: float):
    """A profiler reading, or None where the profiled window held none of
    the call's kernels (it has read 0 ms for a short SDPA call)."""
    return ms if ms > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def device_ms(fn, iters: int = 20, kernel=None):
    """(ms per call of ``fn``, how it was timed).  From the profiler: the
    sum of its kernels' times (with ``kernel``, of the events whose name
    contains it, in a window holding exactly ``iters`` of them), free of
    the host's launch overhead that a tight event-timed loop of small
    calls measures instead.  Where no profiled window was whole, from
    CUDA events around a loop of ``iters`` calls, launch gaps included."""
    def whole(rows):
        return bool(rows) and (kernel is None or sum(
            c for k, _, c in rows if kernel in k) == iters)

    rows = device_events(fn, iters, whole)
    if not rows:
        return time_ms(fn, iters), "cuda events"
    return sum(t for k, t, _ in rows
               if kernel is None or kernel in k) / iters, "profiler"


def _pairs(sq, sk, causal):
    """Unmasked (query, key) pairs of one head, top-left causal."""
    if causal:
        return sum(min(r + 1, sk) for r in range(sq))
    return sq * sk


def attention_work(bh, sq, sk, d, causal, itemsize, bh_kv=None):
    """(operations, bytes) one flash-forward call needs: 4*d per unmasked
    (query, key) pair; q, k, v (``bh_kv`` heads, ``bh`` unless GQA) read
    once, out and lse written once."""
    bh_kv = bh if bh_kv is None else bh_kv
    ops = 4 * d * _pairs(sq, sk, causal) * bh
    nbytes = (2 * bh * sq * d + 2 * bh_kv * sk * d) * itemsize + bh * sq * 4
    return ops, nbytes


def attention_bwd_work(kernel, bh, bh_kv, sq, sk, d, causal, itemsize):
    """(operations, bytes) of one backward kernel.  dK/dV: 8*d per
    unmasked pair (q.k, dO.v, dV += p dO, dK += dS q); dQ: 6*d (q.k, dO.v,
    dQ += dS k).  Each reads q, dO, k, v, lse and delta once; dK/dV writes
    dk and dv once, dQ writes dq once."""
    per_pair = {"flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kernel]
    ops = per_pair * d * _pairs(sq, sk, causal) * bh
    reads = (2 * bh * sq * d + 2 * bh_kv * sk * d) * itemsize + 2 * bh * sq * 4
    writes = (2 * bh_kv * sk * d if kernel == "flash_bwd_dkv"
              else bh * sq * d) * itemsize
    return ops, reads + writes


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


def grad_tolerance(dtype, ref):
    """f32: the backward kernels and the plain version sum up to 2048 terms
    in other orders; 1e-4 of the largest gradient.  bf16: both compute in
    f32 from the same bf16 inputs and round each gradient once; 2 bf16 ulps
    at the largest gradient, as ``out_tolerance``."""
    import torch

    scale = max(1.0, float(ref.float().abs().max()))
    return (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale


def autograd_tolerance(dtype, ref):
    """Gradients of sum(attention ** 2): the two forwards' outputs differ
    by the summation order (f32) or by one bf16 rounding of out and of
    d_out = 2 * out (bf16) before the backward rounds once more; 1e-4 of
    the largest gradient in f32, 4 bf16 ulps in bf16."""
    import torch

    scale = max(1.0, float(ref.float().abs().max()))
    return (1e-4 if dtype == torch.float32 else 2.0 ** -6) * scale


LSE_TOL = 1e-4  # lse is f32 in both; only the summation order differs
# bf16 forwards through the kernel and through the plain attention round
# their attention outputs independently; the 1-ulp differences pass
# through every later layer.  Logit differences are held to 5% of the
# largest logit.
APPLY_TOL = 0.05


# (batch, heads, kv_heads) at which the kernels are held to their plain
# versions, and the plain versions timed, at the Llama-3 trainer's seq 8192:
# the same 4:1 GQA as its 32 heads on 8
LLAMA3_PLAIN = (1, 8, 2)


def check_kernels(report):
    import torch

    from ray_tpu_torch._private import serve_bench
    from ray_tpu_torch.llm.engine import EngineConfig
    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    # every prefill bucket of the serving paths: the engine's defaults and
    # the load wall's (a miss there prefills bucket 240, a partial tile)
    buckets = sorted({*EngineConfig().prefill_buckets,
                      *serve_bench._engine_config().prefill_buckets})
    for dtype in (torch.bfloat16, torch.float32):
        for s in buckets:
            cases.append(("engine_prefill", 1, 12, 12, s, s, 64, True, dtype))
        cases.append(("entry", 2, 8, 4, 256, 256, 64, True, dtype))
        for causal in (True, False):
            cases.append(("llama3_8b", 1, 32, 8, 2048, 2048, 128, causal,
                          dtype))
        cases.append(("ragged", 1, 4, 2, 100, 100, 32, True, dtype))
        cases.append(("ragged", 2, 4, 1, 77, 130, 64, False, dtype))
        cases.append(("mixtral", 1, 32, 8, 4096, 4096, 128, True, dtype))
        # the Llama-3 trainer's seq 8192 at 8 of its 32 heads (the plain
        # version's f32 scores at all 32 would take 17 GB a tensor)
        cases.append(("llama3_s8192", *LLAMA3_PLAIN, 8192, 8192, 128, True,
                      dtype))
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


BWD_CASES = [  # (name, b, h, hkv, sq, sk, d, causal)
    ("trainer", 12, 12, 12, 1024, 1024, 64, True),
    ("seq128", 1, 12, 12, 128, 128, 64, True),
    ("entry", 2, 8, 4, 256, 256, 64, True),
    ("llama3_8b", 1, 32, 8, 2048, 2048, 128, True),
    ("llama3_8b", 1, 32, 8, 2048, 2048, 128, False),
    ("ragged", 1, 4, 2, 100, 100, 32, True),
    ("ragged", 2, 4, 1, 77, 130, 64, False),
    # causal with seq_q < seq_k: KV tiles no query sees (dK, dV exactly 0)
    # and a Q tile partly past seq_q
    ("ragged_causal_wide", 1, 4, 2, 77, 130, 64, True),
    # the MoE trainer's attention: 4:1 GQA at head_dim 128, 16384 terms
    # summed per key in dK/dV
    ("mixtral", 1, 32, 8, 4096, 4096, 128, True),
    # the Llama-3 trainer's seq 8192, 4:1 GQA at 8 of its 32 heads
    ("llama3_s8192", *LLAMA3_PLAIN, 8192, 8192, 128, True),
]


def check_backward(report):
    """The dK/dV and dQ kernels against ``reference_attention_backward`` on
    the same inputs (out and lse from the forward kernel), then gradients
    of sum(attention ** 2) through ``FlashAttention`` against autograd
    through the plain attention."""
    import torch

    from ray_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, h, hkv, sq, sk, d, causal in BWD_CASES:
            q, k, v = make_qkv(gen, b, h, hkv, sq, sk, d, dtype)
            d_out = torch.randn(q.shape, generator=gen, device="cuda").to(
                dtype)
            scale = 1.0 / math.sqrt(d)
            out, lse = attention.flash_forward(q, k, v, causal, scale)
            got = attention.flash_backward(q, k, v, out, lse, d_out, causal,
                                           scale)
            torch.cuda.synchronize()
            want = attention.reference_attention_backward(
                q, k, v, out, lse, d_out, causal, scale)
            row = {"case": name, "b": b, "h": h, "hkv": hkv, "sq": sq,
                   "sk": sk, "d": d, "causal": causal,
                   "dtype": str(dtype)[6:], "ok": True}
            for g_name, a, w in zip(("dq", "dk", "dv"), got, want):
                err = float((a.float() - w.float()).abs().max())
                tol = grad_tolerance(dtype, w)
                row[f"err_{g_name}"], row[f"tol_{g_name}"] = err, tol
                row["ok"] &= (err <= tol
                              and bool(torch.isfinite(a.float()).all()))
            rows.append(row)
            print(f"backward-vs-plain {name:18s} b{b} h{h}/{hkv} s{sq}x{sk} "
                  f"d{d} causal={causal!s:5s} {row['dtype']:8s} " + "  ".join(
                      f"{g} err {row['err_' + g]:.3e} (tol "
                      f"{row['tol_' + g]:.3e})" for g in ("dq", "dk", "dv"))
                  + f"  {'ok' if row['ok'] else 'FAIL'}", flush=True)
    report["backward_checks"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"flash_bwd disagrees with its plain version: {bad}")

    # autograd through the Function against autograd through the plain
    # attention, at entry()'s GQA shape in the (b, s, h, d) layout
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        base = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((2, 256, 8, 64), (2, 256, 4, 64),
                              (2, 256, 4, 64))]
        grads = {}
        for impl, fn in attention.ATTENTION.items():
            leaves = [x.clone().requires_grad_() for x in base]
            loss = (fn(*leaves, causal=True).float() ** 2).sum()
            grads[impl] = torch.autograd.grad(loss, leaves)
        row = {"dtype": str(dtype)[6:], "ok": True}
        for g_name, a, w in zip(("dq", "dk", "dv"), grads["flash"],
                                grads["plain"]):
            err = float((a.float() - w.float()).abs().max())
            tol = autograd_tolerance(dtype, w)
            row[f"err_{g_name}"], row[f"tol_{g_name}"] = err, tol
            row["ok"] &= err <= tol and a.shape == w.shape
        rows.append(row)
        print(f"autograd FlashAttention vs plain, entry GQA 8:4 s256 "
              f"{row['dtype']:8s} " + "  ".join(
                  f"{g} err {row['err_' + g]:.3e} (tol {row['tol_' + g]:.3e})"
                  for g in ("dq", "dk", "dv"))
              + f"  {'ok' if row['ok'] else 'FAIL'}", flush=True)
    report["autograd_checks"] = rows
    if not all(r["ok"] for r in rows):
        raise SystemExit("gradients through FlashAttention disagree")


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
        timed = {n: device_ms(fn, kernel=BF16_KERNELS["flash_fwd"]
                              if n == "kernel" else None)
                 for n, fn in calls.items()}
        dev = {n: measured(ms) for n, (ms, _) in timed.items()}
        wall = {n: time_ms(fn) for n, fn in calls.items()}
        ops, nbytes = attention_work(bh, s, s, d, True, 2)
        bms, by = bound_ms(ops, nbytes, "bfloat16")
        out, _ = attention.flash_forward(q, k, v, True, scale)
        ref, _ = attention.reference_attention(q, k, v, True, scale)
        rows.append({"seq": s, "bh": bh, "d": d, "dtype": "bfloat16",
                     "causal": True, "ms": dev["kernel"],
                     "timed_by": {n: how for n, (_, how) in timed.items()},
                     "plain_ms": dev["plain"], "library_ms": dev["sdpa"],
                     "wall_ms": wall, "bound_ms": bms, "bound_by": by,
                     "ops": ops, "bytes": nbytes,
                     "max_abs_err": float((out.float() - ref.float())
                                          .abs().max())})
        print(f"time flash_fwd bh{bh} s{s} d{d} bf16 causal, device ms per "
              f"call: kernel {fmt_ms(dev['kernel'])} by "
              f"{timed['kernel'][1]}, plain "
              f"{fmt_ms(dev['plain'])}, sdpa {fmt_ms(dev['sdpa'])}, bound "
              f"{bms:.5f} ({by}); wall ms per "
              f"call in a loop: kernel {wall['kernel']:.4f}, plain "
              f"{wall['plain']:.4f}, sdpa {wall['sdpa']:.4f}", flush=True)
    report["kernel_times"] = rows
    return rows


def bwd_kernel_calls(q, k, v, out, lse, d_out, causal, scale):
    """{wrapper name: a call that launches that backward kernel alone} on
    the inputs ``attention.flash_backward`` gives it (its delta computed
    once here), for timing; these launches are not counted."""
    import torch

    from ray_tpu_torch.ops import _build, attention

    lib = _build.library("flash_bwd", attention._bind_bwd)
    delta = attention._delta(out, d_out)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    shape = (q.shape[0], k.shape[0], q.shape[1], k.shape[1], q.shape[2],
             int(causal), float(scale), attention._DTYPE_CODES[q.dtype])
    ins = tuple(x.data_ptr() for x in (q, k, v, d_out, lse, delta))
    stream = torch.cuda.current_stream().cuda_stream

    def checked(entry, *outs):
        def call():
            if entry(*ins, *(x.data_ptr() for x in outs), *shape, stream):
                raise RuntimeError(f"{entry.__name__} launch failed")
            return outs
        return call

    return {"flash_bwd_dkv": checked(lib.rtt_flash_bwd_dkv, dk, dv),
            "flash_bwd_dq": checked(lib.rtt_flash_bwd_dq, dq)}


def launch_counts():
    """The three wrappers' host launch counters."""
    from ray_tpu_torch.ops import attention

    return {"flash_fwd": attention.flash_forward.launches,
            **attention.flash_backward.launches}


def zero_launch_counts():
    from ray_tpu_torch.ops import attention

    attention.flash_forward.launches = 0
    for key in attention.flash_backward.launches:
        attention.flash_backward.launches[key] = 0


def kernel_counts(rows, names):
    """Launches of each kernel in ``names`` among profiled device events
    (a name counts the events whose demangled name contains it)."""
    return {n: sum(c for k, _, c in rows if n in k) for n in names}


# (name, batch, heads, kv_heads, seq, head_dim) of the attention the main
# training paths give the kernels, bf16 and causal: bench.py's GPT-2 124M
# trainer, Mixtral 8x7B's (32 query heads on 8 KV heads, head_dim 128) and
# the Llama-3 8B recipe's (the same heads, batch 2 x seq 8192)
TRAINER_SHAPE = ("trainer", 12, 12, 12, 1024, 64)
MIXTRAL_SHAPE = ("mixtral", 1, 32, 8, 4096, 128)
LLAMA3_SHAPE = ("llama3", 2, 32, 8, 8192, 128)


def time_attention(report, reading: int, shape=TRAINER_SHAPE, plain=None):
    """The three kernels at one training path's attention shape: device ms
    per call of the bf16 kernels (``BF16_KERNELS``, by name from the
    profiler) against the plain versions, SDPA forward and SDPA backward
    under autograd (the library yardsticks, timed only; GQA K/V repeated
    outside the timed call), and the bounds.  Run twice in one script
    (``reading`` 1 and 2): a stand-alone kernel time moves by up to 16%
    between readings on this machine.  With ``plain`` (batch, heads,
    kv_heads) the plain versions, whose f32 scores would not fit at
    ``shape``, are timed at those heads and the kernels' errors taken
    there; kernel, SDPA and bound stay at ``shape``."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    name, b, h, hkv, s, d = shape
    dtype = torch.bfloat16
    bh, bh_kv = b * h, b * hkv
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = make_qkv(gen, b, h, hkv, s, s, d, dtype)
    d_out = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = 1.0 / math.sqrt(d)
    out, lse = attention.flash_forward(q, k, v, True, scale)
    qp, kp, vp, dp, outp, lsep = q, k, v, d_out, out, lse
    if plain is not None:
        qp, kp, vp = make_qkv(gen, *plain, s, s, d, dtype)
        dp = torch.randn(qp.shape, generator=gen, device="cuda").to(dtype)
        outp, lsep = attention.flash_forward(qp, kp, vp, True, scale)
    q4, do4 = (x.view(b, h, s, d) for x in (q, d_out))
    k4, v4 = (x.view(b, hkv, s, d).repeat_interleave(h // hkv, dim=1)
              for x in (k, v))
    leaves = [x.clone().requires_grad_() for x in (q4, k4, v4)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              scale=scale)

    # each kernel alone, so that a window must hold exactly its calls and
    # CUDA events can time it where no window does
    one_kernel = {"flash_fwd": lambda: attention.flash_forward(
        q, k, v, True, scale),
        **bwd_kernel_calls(q, k, v, out, lse, d_out, True, scale)}
    timed = {
        **{kname: device_ms(fn, 20 if kname == "flash_fwd" else 10,
                            BF16_KERNELS[kname])
           for kname, fn in one_kernel.items()},
        "plain_fwd": device_ms(
            lambda: attention.reference_attention(qp, kp, vp, True, scale),
            5),
        "plain_bwd": device_ms(
            lambda: attention.reference_attention_backward(
                qp, kp, vp, outp, lsep, dp, True, scale), 5),
        "sdpa_fwd": device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, scale=scale)),
        "sdpa_bwd": device_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, do4, retain_graph=True)),
    }
    dev = {key: ms for key, (ms, _) in timed.items()}
    ref_out, _ = attention.reference_attention(qp, kp, vp, True, scale)
    got = attention.flash_backward(qp, kp, vp, outp, lsep, dp, True, scale)
    want = attention.reference_attention_backward(qp, kp, vp, outp, lsep, dp,
                                                  True, scale)
    errs = [float((a.float() - w.float()).abs().max())
            for a, w in zip(got, want)]
    del got, want
    rows = {}
    for kname, plain_key, lib, err in (
            ("flash_fwd", "plain_fwd", "sdpa_fwd",
             float((outp.float() - ref_out.float()).abs().max())),
            ("flash_bwd_dkv", "plain_bwd", "sdpa_bwd", max(errs[1:])),
            ("flash_bwd_dq", "plain_bwd", "sdpa_bwd", errs[0])):
        if kname == "flash_fwd":
            ops, nbytes = attention_work(bh, s, s, d, True, 2, bh_kv)
        else:
            ops, nbytes = attention_bwd_work(kname, bh, bh_kv, s, s, d,
                                             True, 2)
        bms, by = bound_ms(ops, nbytes, "bfloat16")
        for key in (kname, plain_key):
            if dev[key] <= 0:
                raise SystemExit(f"no time for {key} at the {name} shape")
        # no kernel beats the card's peaks: a time below the bound is a
        # measurement that lost work
        if dev[kname] < bms:
            raise SystemExit(f"{kname} at the {name} shape read "
                             f"{dev[kname]:.5f} ms ({timed[kname][1]}), "
                             f"below its {bms:.5f} ms bound")
        lib_ms = measured(dev[lib])
        rows[kname] = {"ms": dev[kname], "timed_by": timed[kname][1],
                       "plain_ms": dev[plain_key],
                       "plain_timed_by": timed[plain_key][1],
                       "library_ms": lib_ms, "library_timed_by": timed[lib][1],
                       "bound_ms": bms,
                       "bound_by": by, "ops": ops, "bytes": nbytes,
                       "tflops": ops / dev[kname] / 1e9,
                       "bound_share": bms / dev[kname], "max_abs_err": err}
        at = ""
        if plain is not None:
            rows[kname]["plain_shape"] = {"b": plain[0], "h": plain[1],
                                          "hkv": plain[2]}
            at = f" at b{plain[0]} h{plain[1]}/{plain[2]}"
        print(f"time #{reading} {kname} ({BF16_KERNELS[kname]}) {name} shape "
              f"b{b} h{h}/{hkv} s{s} d{d} bf16 causal, device ms per call: "
              f"kernel {dev[kname]:.4f} by {timed[kname][1]} "
              f"({ops / dev[kname] / 1e9:.1f} "
              f"TFLOP/s, {bms / dev[kname]:.3f} of bound), plain{at} "
              f"{dev[plain_key]:.4f} ({plain_key}, {timed[plain_key][1]}), "
              f"sdpa {fmt_ms(lib_ms)} ({lib}, {timed[lib][1]}), "
              f"bound {bms:.5f} ({by}: {ops:.3e} ops, {nbytes / 1e6:.1f} MB)"
              f"; max abs err vs plain {err:.3e}", flush=True)
    report.setdefault(f"{name}_kernel_times", []).append(rows)
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


def mix_prompt(i: int, n: int, vocab: int):
    """``n`` token ids from seed ``i``: no two seeds share a first page."""
    return [(7 * i + 13 * j + 1) % vocab for j in range(n)]


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
        return mix_prompt(i, n, vocab)

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
        fwd = BF16_KERNELS["flash_fwd"]
        fwd_ms = sum(t for k, t, _ in rows_ if fwd in k)
        out[name] = {"ms": ms, "device_ms": busy, f"{fwd}_ms": fwd_ms,
                     "kernel_launches": kernel_counts(
                         rows_, (fwd, *SCALAR_KERNELS)),
                     "top": [{"kernel": k[:90], "ms": t, "count": c}
                             for k, t, c in rows_[:8]]}
        print(f"step {name}: {ms:.3f} ms per call, device busy "
              f"{busy:.3f} ms ({fwd} {fwd_ms:.4f} ms, launches "
              f"{out[name]['kernel_launches']}); top: " + "; ".join(
                  f"{k[:40]} {t:.3f} ms x{c}" for k, t, c in rows_[:4]),
              flush=True)
    got = out["prefill_128"]["kernel_launches"]
    if got[BF16_KERNELS["flash_fwd"]] != cfg.n_layers or any(
            got[k] for k in SCALAR_KERNELS):
        raise SystemExit(f"a bucket-128 prefill launched {got}: want "
                         f"{cfg.n_layers} tensor-core forwards and no scalar "
                         f"kernel")
    return out


class Handle:
    """In-process stand-in for a serve deployment handle: ``.options(
    routing_hint=...).<method>.remote(...).result(timeout_s=...)`` calls
    the server directly and keeps every (method, result)."""

    def __init__(self, target):
        self.target, self.calls = target, []

    def options(self, routing_hint=None):
        return self

    def __getattr__(self, method):
        fn, calls = getattr(self.target, method), self.calls

        def remote(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((method, out))
            return types.SimpleNamespace(result=lambda timeout_s=None: out)

        return types.SimpleNamespace(remote=remote)


def server_load_window(router, base: int, max_tokens: int, vocab: int):
    """``run_engine``'s 19-request mix as concurrent streamed
    ``/v1/completions`` through ``router``, one client thread each: 16
    prompts of 128 tokens, one of 600, one sampled, and one sharing
    request 0's first 7 pages, sent once request 0 streamed its first
    token.  ``base`` offsets the prompt seeds so that every window starts
    cold.  ``ignore_eos`` holds each stream to ``max_tokens``.  Returns
    each request's (content chunks, finish reason) and the window's wall
    seconds, first send to last chunk."""
    import threading

    def p(i, n):
        return mix_prompt(base + i, n, vocab)

    bodies = [{"prompt": p(i, 128)} for i in range(16)]
    bodies += [{"prompt": p(100, 600)},
               {"prompt": p(101, 128), "temperature": 0.8, "seed": 7},
               {"prompt": p(0, 128)[:112] + p(102, 16)}]
    first = threading.Event()  # request 0 streamed its first token
    out = [None] * len(bodies)

    def client(i):
        n, reason = 0, None
        try:
            if i == len(bodies) - 1:
                first.wait(300)
            resp = router.handle_http({"path": "/v1/completions", "body": dict(
                bodies[i], max_tokens=max_tokens, ignore_eos=True,
                stream=True)})
            for ch in resp.chunks:
                if ch == "data: [DONE]\n\n":
                    break
                choice = json.loads(ch[len("data: "):])["choices"][0]
                reason = choice["finish_reason"]
                if reason is None:
                    n += 1
                    if i == 0:
                        first.set()
        except Exception as e:  # noqa: BLE001 — reported as the reason
            reason = repr(e)
        finally:
            if i == 0:
                first.set()
            out[i] = (n, reason)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.monotonic() - t0


# Prompt sizes in bytes for the P/D and tier checks; the largest (601 tokens
# with BOS) fills 37 full pages of 16.
FRONTEND_BYTES = (40, 128, 300, 600)
FRONTEND_WORDS = ("tensor", "page", "cache", "decode", "prefill", "router",
                  "token", "kernel", "spine", "family", "stream", "request",
                  "replica", "latency", "budget", "handoff")


def frontend_prompt(i: int, n_bytes: int) -> str:
    """``n_bytes`` of words from seed ``i``, led by ``i`` so that no two
    prompts share a first page."""
    import random

    rng = random.Random(1000 + i)
    text = f"{i:03d}"
    while len(text) < n_bytes:
        text += " " + rng.choice(FRONTEND_WORDS)
    return text[:n_bytes]


def spans_by_trace(spans):
    traces = {}
    for s in spans:
        traces.setdefault(s["trace_id"], []).append(s)
    return traces


def tree_edges(node, out):
    for child in node["children"]:
        out.add((node["name"], child["name"]))
        tree_edges(child, out)
    return out


def metric_total(name):
    """A counter's total, or a histogram's observation count, over tags."""
    from ray_tpu_torch.util import metrics

    for snap in metrics.snapshot():
        if snap["name"] == name:
            if snap["kind"] == "histogram":
                return sum(sum(h[:-1]) for h in snap["hist"].values())
            return sum(snap["values"].values())
    return 0


def span_p50(spans):
    """Median ms of the engine's phase spans, and of the prefill span by
    path: bucketed through the kernel (no resident prefix), or a suffix
    after a prefix hit or copy-on-write page through the plain attention."""
    import statistics

    def p50(durs):
        return statistics.median(durs) if durs else None

    def ms(s):
        return (s["end_ts"] - s["start_ts"]) * 1e3

    out = {name: p50([ms(s) for s in spans if s["name"] == name])
           for name in ("llm.queue", "llm.prefill", "llm.decode")}
    for path, hit in (("kernel", False), ("suffix", True)):
        durs = [ms(s) for s in spans if s["name"] == "llm.prefill"
                and bool(s["args"].get("prefix_len")) == hit]
        out[f"llm.prefill {path}"] = p50(durs)
        out[f"llm.prefill {path} n"] = len(durs)
    return out


def cuda_ms(fn, iters: int = 5):
    """Median wall ms of ``fn`` followed by a device synchronise."""
    import statistics

    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_frontends(report):
    """The serving front ends at the serving width (the model and engine
    config of ``run_engine``): the P/D handoff over the host relay (token
    ids equal to a single engine's, injected pages equal to the prefill
    engine's), the KV tier (seal, prehydrate, pages equal, the P/D tier
    handoff, a torn blob's typed fallback), ``LLMServer`` behind
    ``OpenAIRouter`` (SSE well formed, streamed and whole responses
    agree; then ``run_engine``'s 19-request mix sent concurrently, read
    twice), batch inference, and the spans and metrics they leave.
    Returns the forward kernel's launches during the phase."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import batch as batch_mod
    from ray_tpu_torch.llm import kv_tier as kt
    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.llm.engine import (EngineConfig, LLMEngine,
                                          SamplingParams)
    from ray_tpu_torch.llm.paged_cache import CacheConfig, init_cache
    from ray_tpu_torch.llm.pd_disagg import (DecodeServer, PDRouter,
                                             PrefillServer)
    from ray_tpu_torch.llm.server import LLMConfig, LLMServer, OpenAIRouter
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.util import metrics, tracing

    cfg = llama.LlamaConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, max_seq_len=1024, remat=False)
    state = llama.cast_weights(llama.init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)  # cast once: every engine then shares the bf16 weights
    ecfg = EngineConfig(max_slots=16, num_pages=512, page_size=16,
                        max_seq_len=1024)
    llm_cfg = LLMConfig(model_id="serving-768", model_loader=lambda: (
        state, cfg), engine_config=ecfg, default_max_tokens=32)
    tok = ByteTokenizer()
    eos = (tok.eos_id,)
    max_tokens = 32
    texts = [frontend_prompt(i, n) for i, n in enumerate(FRONTEND_BYTES)]
    prompts = [tok.encode(t) for t in texts]
    long_prompt = prompts[-1]
    ps = ecfg.page_size
    full_pages = len(long_prompt) // ps
    res = {"prompt_tokens": [len(p) for p in prompts]}
    engines = []  # every engine of the phase, stopped at its end
    expect = {"ttft": 0}  # requests that emit a first token on an engine

    def engine(tier=None):
        e = LLMEngine(state, cfg, ecfg, kv_tier=tier)
        e.start()
        engines.append(e)
        return e

    def emitted(n):
        expect["ttft"] += int(n >= 1)

    def fallbacks(reason):
        for snap in metrics.snapshot():
            if snap["name"] == "llm_kv_pull_fallbacks_total":
                return snap["values"].get((reason,), 0.0)
        return 0.0

    def pages_of(e, tokens):
        """The KV of ``tokens``' resident full pages.  Only on a stopped or
        idle engine: its scheduler thread owns the prefix cache."""
        with torch.inference_mode():
            return lm.extract_pages(e.cache_k, e.cache_v,
                                    e.prefix_cache.match(tokens))

    tracing.take_spans()
    ttft0, prefills0 = metric_total("llm_ttft_s"), metric_total(
        "llm_prefills_total")
    attention.flash_forward.launches = 0
    t_phase = time.monotonic()
    servers = []
    try:
        # 1. P/D over the host relay against a fresh single engine per prompt
        pre, dec = PrefillServer(llm_cfg), DecodeServer(llm_cfg)
        servers += [pre, dec]
        pre_h, dec_h = Handle(pre), Handle(dec)
        pd_router = PDRouter(pre_h, dec_h, "serving-768", max_tokens)
        pd_rows = []
        for text, prompt in zip(texts, prompts):
            resp = pd_router.handle_http({"path": "/v1/completions", "body": {
                "prompt": text, "max_tokens": max_tokens}})
            got = dec_h.calls[-1][1]["tokens"]
            emitted(len(got) - 1)
            single = engine()
            want = single.generate(prompt, SamplingParams(
                max_tokens=max_tokens, stop_token_ids=eos))
            emitted(len(want))
            single.stop()
            first_diff = next((j for j, (a, b) in enumerate(zip(got, want))
                               if a != b), None)
            pd_rows.append({"tokens": len(prompt), "pd": len(got),
                            "single": len(want), "equal": got == want,
                            "first_diff": first_diff,
                            "usage": resp["usage"]})
            print(f"frontends P/D host relay, prompt {len(prompt)} tokens: "
                  f"{len(got)} ids, equal to a single engine's: "
                  f"{got == want} (first difference at {first_diff})",
                  flush=True)
        res["pd_host"] = pd_rows
        if not all(r["equal"] and r["pd"] == max_tokens for r in pd_rows):
            raise SystemExit(f"P/D token ids differ from a single engine's "
                             f"or streamed short: {pd_rows}")
        pre.shutdown()  # a finished request's pages register after its
        dec.shutdown()  # stream ends: join the schedulers before reading
        shipped = pre_h.calls[-1][1]
        pre_pages = pages_of(pre._engine, long_prompt)
        dec_pages = pages_of(dec._engine, long_prompt)
        same = all(
            len(p[0][0]) == full_pages and torch.equal(p[0], s[:, :full_pages])
            and torch.equal(p[1], t[:, :full_pages])
            for p, s, t in ((pre_pages, shipped["kv_k"], shipped["kv_v"]),
                            (dec_pages, shipped["kv_k"], shipped["kv_v"])))
        res["pd_pages_equal"] = same
        print(f"frontends P/D: the decode engine's {full_pages} injected "
              f"pages equal the prefill engine's: {same}", flush=True)
        if not same:
            raise SystemExit("injected KV pages differ from the prefill "
                             "engine's")

        # the handoff's page movement for the 600-byte prompt, timed alone
        nbytes = 2 * pre_pages[0].numel() * pre_pages[0].element_size()
        ccfg = CacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                           head_dim=cfg.head_dim, num_pages=full_pages + 1,
                           page_size=ps, dtype=cfg.dtype)
        scratch = init_cache(ccfg, "cuda")
        src = pre._engine.prefix_cache.match(long_prompt)
        dst = list(range(1, full_pages + 1))
        with torch.inference_mode():
            extract_ms = cuda_ms(lambda: lm.extract_pages(
                pre._engine.cache_k, pre._engine.cache_v, src))
            inject_ms = cuda_ms(lambda: lm.inject_kv_pages(
                *scratch, dst, *pre_pages))
            # seal and hydrate of the same spine through a KV tier
            tier0 = kt.KVTier(kt.InProcessStore(), kt.LocalDirectory())
            root = pre._engine.prefix_cache.root_digest_for(long_prompt, ps)
            oid = tier0.oid_for(root, full_pages)

            def seal():
                k, v = lm.extract_pages(pre._engine.cache_k,
                                        pre._engine.cache_v, src)
                tier0.store.put(oid, kt.encode_spine(
                    long_prompt[:full_pages * ps], k, v, ps))
                tier0.directory.publish(root, {"oid": oid.hex(),
                                               "blocks": full_pages})

            def hydrate():
                _, k, v = tier0.pull(root)
                lm.inject_kv_pages(*scratch, dst, k, v)

            seal_ms, hydrate_ms = cuda_ms(seal), cuda_ms(hydrate)
            blob_bytes = len(tier0.store.get_bytes(oid))
        hydrated_same = (torch.equal(scratch[0][:, 1:], pre_pages[0].cuda())
                         and torch.equal(scratch[1][:, 1:],
                                         pre_pages[1].cuda()))
        del scratch
        res["handoff"] = {
            "pages": full_pages, "bytes": nbytes, "extract_ms": extract_ms,
            "inject_ms": inject_ms, "extract_gb_s": nbytes / extract_ms / 1e6,
            "inject_gb_s": nbytes / inject_ms / 1e6, "seal_ms": seal_ms,
            "hydrate_ms": hydrate_ms, "blob_bytes": blob_bytes,
            "hydrated_equal": hydrated_same}
        print(f"frontends handoff of {full_pages} pages ({nbytes / 1e6:.1f} "
              f"MB of K+V, median of 5): extract to host {extract_ms:.3f} ms "
              f"= {nbytes / extract_ms / 1e6:.2f} GB/s, inject to the card "
              f"{inject_ms:.3f} ms = {nbytes / inject_ms / 1e6:.2f} GB/s; "
              f"seal (extract + KVT1 encode + put) {seal_ms:.3f} ms, hydrate "
              f"(get + decode + inject) {hydrate_ms:.3f} ms, blob "
              f"{blob_bytes / 1e6:.1f} MB; hydrated pages equal: "
              f"{hydrated_same}", flush=True)
        if not hydrated_same:
            raise SystemExit("pages hydrated from a KVT1 blob differ")

        # 2. KV tier: A seals the long prompt, a fresh B prehydrates it
        store, directory = kt.InProcessStore(), kt.LocalDirectory()
        sp = SamplingParams(max_tokens=max_tokens)
        a = engine(kt.KVTier(store, directory, seal_min_hits=1))
        a_first = a.generate(long_prompt, sp)
        a.generate(long_prompt, sp)
        a.stop()  # its last seal (prompt + generated KV) lands after the
        emitted(len(a_first))  # stream ends
        emitted(1)
        tier_b = kt.KVTier(store, directory, seal_min_hits=1)
        b = engine(tier_b)
        roots = tier_b.hottest(8)
        b.kv_prehydrate(roots)
        deadline = time.monotonic() + 60
        while b.stats()["kv_pulls"] < 1:
            if time.monotonic() > deadline:
                raise SystemExit("KV tier prehydrate never pulled")
            time.sleep(0.005)
        rec = directory.lookup(roots[0])
        spine_tokens, sealed_k, sealed_v = tier_b.pull(roots[0])
        probe = list(spine_tokens) + [0]
        b_k, b_v = pages_of(b, probe)
        a_k, a_v = pages_of(a, probe)
        hyd_equal = (torch.equal(b_k, sealed_k) and torch.equal(b_v, sealed_v)
                     and torch.equal(a_k, sealed_k)
                     and torch.equal(a_v, sealed_v))
        b_out = b.generate(long_prompt, sp)
        emitted(len(b_out))
        b.stop()
        st_b = b.stats()
        agree = next((j for j, (x, y) in enumerate(zip(b_out, a_first))
                      if x != y), len(b_out))
        res["tier"] = {
            "sealed_blocks": rec["blocks"], "kv_seals_a": a.stats()[
                "kv_seals"], "kv_pulls_b": st_b["kv_pulls"],
            "kv_pull_pages_b": st_b["kv_pull_pages"],
            "prefill_tokens_saved_b": st_b["prefill_tokens_saved"],
            "hydrated_equal": hyd_equal, "b_tokens": len(b_out),
            "b_leading_tokens_equal_a": agree}
        print(f"frontends KV tier: A sealed {a.stats()['kv_seals']} times, "
              f"{rec['blocks']} blocks deep (prompt + generated KV); B pulled "
              f"{st_b['kv_pulls']} spine(s), {st_b['kv_pull_pages']} pages, "
              f"saved {st_b['prefill_tokens_saved']} prompt tokens; B's "
              f"pages equal A's sealed pages: {hyd_equal}; B streamed "
              f"{len(b_out)} tokens, the first {agree} equal to A's first "
              f"stream (reported only)", flush=True)
        if not (st_b["kv_pulls"] >= 1 and st_b["kv_pull_pages"]
                == rec["blocks"] >= full_pages
                and st_b["prefill_tokens_saved"] > 0 and hyd_equal
                and len(b_out) == max_tokens):
            raise SystemExit(f"the KV tier pull failed its checks: "
                             f"{res['tier']}")

        # the P/D tier handoff: the decode side pulls what prefill sealed
        kt.set_default_tier(kt.KVTier(kt.InProcessStore(),
                                      kt.LocalDirectory()))
        try:
            pre_t, dec_t = PrefillServer(llm_cfg), DecodeServer(llm_cfg)
        finally:
            kt.set_default_tier(None)
        servers += [pre_t, dec_t]
        pre_t_h, dec_t_h = Handle(pre_t), Handle(dec_t)
        tier_router = PDRouter(pre_t_h, dec_t_h, "serving-768", max_tokens)
        lens = []
        for text in texts:
            tier_router.handle_http({"path": "/v1/completions", "body": {
                "prompt": text, "max_tokens": max_tokens}})
            lens.append(len(dec_t_h.calls[-1][1]["tokens"]))
            emitted(lens[-1])
        pre_t.shutdown()
        dec_t.shutdown()
        st = dec_t.engine_stats()
        res["pd_tier"] = {"tokens": lens, "kv_pulls": st["kv_pulls"],
                          "kv_pull_pages": st["kv_pull_pages"],
                          "prefills": st["prefills"],
                          "kv_in_tier": all(
                              r.get("kv_in_tier") and "kv_k" not in r
                              for _, r in pre_t_h.calls)}
        print(f"frontends P/D tier handoff: streams {lens}; the decode "
              f"engine pulled {st['kv_pulls']} spines, "
              f"{st['kv_pull_pages']} pages, and ran {st['prefills']} "
              f"suffix prefills", flush=True)
        if not (all(n == max_tokens for n in lens) and st["kv_pulls"] >= 1
                and res["pd_tier"]["kv_in_tier"]):
            raise SystemExit(f"the P/D tier handoff failed: {res['pd_tier']}")

        # a torn blob: typed fallback to a cold prefill
        with store._lock:
            for key in list(store._objs):
                store._objs[key] = store._objs[key][:len(store._objs[key])
                                                    // 2]
        torn0 = fallbacks("truncated")
        c = engine(kt.KVTier(store, directory, seal_min_hits=1))
        c_out = c.generate(long_prompt, sp)
        c.stop()
        emitted(len(c_out))
        torn = fallbacks("truncated") - torn0
        res["torn_blob"] = {"tokens": len(c_out), "truncated_fallbacks": torn,
                            "kv_pull_fallbacks": c.stats()[
                                "kv_pull_fallbacks"]}
        print(f"frontends torn blob: {len(c_out)} tokens streamed after a "
              f"cold prefill; fallbacks by reason truncated +{torn:g}",
              flush=True)
        if not (len(c_out) == max_tokens and torn == 1
                and c.stats()["kv_pull_fallbacks"] == 1):
            raise SystemExit(f"the torn-blob fallback failed: "
                             f"{res['torn_blob']}")

        # 3. LLMServer behind OpenAIRouter
        server = LLMServer(llm_cfg)
        servers.append(server)
        got = server.generate_tokens(prompts[1], max_tokens=max_tokens)
        emitted(len(got))
        single = engine()
        want = single.generate(prompts[1], SamplingParams(
            max_tokens=max_tokens))
        emitted(len(want))
        single.stop()
        router = OpenAIRouter(Handle(server), "serving-768")
        listed = router.handle_http({"path": "/v1/models"})
        bodies = [("/v1/completions", {"prompt": texts[0],
                                       "max_tokens": 16}),
                  ("/v1/chat/completions", {"messages": [
                      {"role": "user", "content": texts[1]}],
                      "max_tokens": 16})]
        srv_rows = []
        for path, body in bodies:
            whole = router.handle_http({"path": path, "body": dict(body)})
            stream = router.handle_http({"path": path, "body": dict(
                body, stream=True)})
            chunks = list(stream.chunks)
            events, well_formed = [], chunks[-1] == "data: [DONE]\n\n"
            for ch in chunks[:-1]:
                well_formed &= ch.startswith("data: ") and ch.endswith(
                    "\n\n")
                events.append(json.loads(ch[len("data: "):]))
            content = [e for e in events[:-1]
                       if e["choices"][0].get("delta") != {
                           "role": "assistant"}]
            n_whole = whole["usage"]["completion_tokens"]
            emitted(n_whole)
            emitted(len(content))
            srv_rows.append({
                "path": path, "chunks": len(chunks),
                "content_chunks": len(content), "completion_tokens": n_whole,
                "finish_whole": whole["choices"][0]["finish_reason"],
                "finish_stream": events[-1]["choices"][0]["finish_reason"],
                "well_formed": well_formed,
                "content_type": stream.content_type})
        res["server"] = {
            "generate_tokens_equal": got == want, "models": listed,
            "requests": srv_rows}
        print(f"frontends OpenAI server: generate_tokens equal to a single "
              f"engine's: {got == want}; " + "; ".join(
                  f"{r['path']} {r['completion_tokens']} tokens whole / "
                  f"{r['content_chunks']} SSE content chunks of "
                  f"{r['chunks']}, finish {r['finish_whole']}/"
                  f"{r['finish_stream']}, well formed {r['well_formed']}"
                  for r in srv_rows), flush=True)
        if not (got == want and listed["data"][0]["id"] == "serving-768"
                and all(r["well_formed"] and r["completion_tokens"]
                        == r["content_chunks"] == 16
                        and r["finish_whole"] == r["finish_stream"]
                        == "length"
                        and r["content_type"] == "text/event-stream"
                        for r in srv_rows)):
            raise SystemExit(f"the OpenAI server failed its checks: "
                             f"{res['server']}")

        # the server's rate and span anatomy over a real window, read
        # twice: run_engine's mix sent concurrently through the router
        kept_spans, load_spans, loads = tracing.take_spans(), [], []
        for w in (1, 2):
            window, wall = server_load_window(router, 300 * w, max_tokens,
                                              cfg.vocab_size)
            win_spans = tracing.take_spans()
            load_spans += win_spans
            n_tok = sum(n for n, _ in window)
            for n, _ in window:
                emitted(n)
            loads.append({"requests": len(window), "tokens": n_tok,
                          "wall_s": wall, "output_tok_s": n_tok / wall,
                          "span_p50_ms": span_p50(win_spans),
                          "short": [(i, n, r) for i, (n, r) in
                                    enumerate(window)
                                    if (n, r) != (max_tokens, "length")]})
            print(f"frontends OpenAI server load, reading {w}: "
                  f"{len(window)} concurrent streamed requests, {n_tok} "
                  f"tokens in {wall:.3f} s = {n_tok / wall:.1f} output "
                  f"tok/s; span p50 ms: " + ", ".join(
                      f"{k} {v}" if k.endswith(" n") else f"{k} {fmt_ms(v)}"
                      for k, v in loads[-1]["span_p50_ms"].items()),
                  flush=True)
        res["server_load"] = loads
        if any(ld["short"] for ld in loads):
            raise SystemExit(f"server load requests streamed short: "
                             f"{[ld['short'] for ld in loads]}")
        server.shutdown()

        # 4. batch inference over a numpy batch of 8 prompts
        udf = batch_mod._EngineUDF(batch_mod.ProcessorConfig(
            model_loader=llm_cfg.model_loader, engine_config=ecfg,
            sampling={"max_tokens": 16}))
        engines.append(udf._engine)
        out = udf({"prompt": np.array([frontend_prompt(20 + i, 64)
                                       for i in range(8)])})
        udf.shutdown()
        rows = [len(t) for t in out["generated_tokens"]]
        for n in rows:
            emitted(n)
        res["batch"] = {"rows": rows}
        print(f"frontends batch: 8 prompts, tokens per row {rows}",
              flush=True)
        if rows != [16] * 8:
            raise SystemExit(f"batch rows streamed short: {rows}")
        torch.cuda.synchronize()
        launches = attention.flash_forward.launches
        phase_s = time.monotonic() - t_phase
    finally:
        kt.set_default_tier(None)
        for s in servers:
            s.shutdown()
        for e in engines:
            e.stop()

    # 5. spans and metrics of the phase
    spans = kept_spans + load_spans + tracing.take_spans()
    counts, bad = {"openai.request": 0, "pd.request": 0}, []
    need = {"openai.request": {("openai.request", "llm.request"),
                               ("llm.request", "llm.queue"),
                               ("llm.request", "llm.prefill"),
                               ("llm.request", "llm.decode")},
            "pd.request": {("pd.request", "pd.prefill"),
                           ("pd.prefill", "pd.decode"),
                           ("pd.decode", "llm.request"),
                           ("llm.request", "llm.decode")}}
    for tid, trace_spans in spans_by_trace(spans).items():
        tree = tracing.assemble_trace(tid, trace_spans)["tree"]
        root = tree[0]["name"]
        edges = tree_edges(tree[0], set())
        if len(tree) != 1 or root not in need or not need[root] <= edges:
            bad.append((root, len(tree), sorted(edges)))
            continue
        counts[root] += 1
    p50 = span_p50(load_spans)  # both server load windows
    all_engines = engines + [s._engine for s in servers]
    d_ttft = metric_total("llm_ttft_s") - ttft0
    d_prefills = metric_total("llm_prefills_total") - prefills0
    want_prefills = sum(e.stats()["prefills"] for e in all_engines)
    res.update({"traces": counts, "bad_traces": bad, "spans": len(spans),
                "span_p50_ms": p50, "ttft_observed": d_ttft,
                "ttft_expected": expect["ttft"], "prefills_metric": d_prefills,
                "prefills_engines": want_prefills, "flash_launches": launches,
                "phase_s": phase_s})
    report["frontends"] = res
    print(f"frontends traces: {counts} connected trees ({len(spans)} spans"
          f", {len(bad)} malformed); span p50 ms over both load windows: "
          + ", ".join(
              f"{k} {v}" if k.endswith(" n") else f"{k} {fmt_ms(v)}"
              for k, v in p50.items())
          + f"; TTFT observations +{d_ttft:g} (expected {expect['ttft']}), "
          f"prefills +{d_prefills:g} (engines' own {want_prefills}); flash "
          f"forward launches {launches}; phase {phase_s:.1f} s", flush=True)
    want_counts = {"openai.request": 4 + sum(ld["requests"] for ld in loads),
                   "pd.request": 8}
    if bad or counts != want_counts:
        raise SystemExit(f"request traces are not connected trees: {counts} "
                         f"{bad[:3]}")
    if d_ttft != expect["ttft"] or d_prefills != want_prefills:
        raise SystemExit("the engine metrics disagree with the phase's own "
                         "counts")
    if launches <= 0:
        raise SystemExit("the front ends never launched the flash kernel")
    del state
    torch.cuda.empty_cache()
    return launches


# The routed-serving phase: the load-wall ladder and the kill rung of
# ``ray_tpu_torch/_private/serve_bench.py`` (the reference's, cut below) over
# two engines at the serving width, then the top prefix-aware cell once
# more at half its requests with the card profiled over a 2 s window.
# Profiler windows later in the process can lose kernel events after
# the engines' threads' thousands of launches; ``device_events`` takes
# only whole windows, and a time falls back to CUDA events.  The profiler
# slows the host-bound engines, so the window's device ms per prefill is
# projected onto the unprofiled cell's rate.
SERVE_BENCH_SEED = 7
SERVE_PROFILE_S = 2.0
# The reference's ladder with its top rung cut from 1024 requests to 512
# (concurrency and width kept): at 1024 the phase took 98.8-199.2 s with
# the host's speed against its 150 s budget (NVIDIA H100 80GB HBM3).
SERVE_LADDER = ((4, 128), (16, 256), (32, 512))


def serving_model():
    """``bench.py``'s serving model (``run_engine``'s), cast to bf16 once
    so that every engine shares the weights."""
    import torch

    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, max_seq_len=1024, remat=False)
    state = llama.cast_weights(llama.init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)
    return state, cfg


def serve_busy_share(sb, model, n_requests, concurrency, start_s):
    """Run a prefix-aware cell of ``n_requests`` at ``concurrency`` in a
    thread and profile the card's kernels for ``SERVE_PROFILE_S`` from
    ``start_s`` seconds after it starts; a window that saw no prefill or
    no kernel (one has, in a run whose cell ran) is profiled again while
    the cell runs, up to ``PROFILE_ATTEMPTS`` windows.  Only device
    activity is traced: tracing the engines' host ops would slow them
    further.  Returns the cell's result, the windows profiled, and the
    last window's ms, prefills, device-busy ms and top kernels."""
    import threading

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.request_router import PrefixAwareRouter

    out = {}

    def cell():
        try:
            out["cell"] = sb._run_cell(model, PrefixAwareRouter, n_requests,
                                       concurrency, SERVE_BENCH_SEED, "cuda")
        except Exception as e:  # noqa: BLE001 — re-raised by the caller
            out["error"] = e

    t = threading.Thread(target=cell)
    t.start()
    time.sleep(start_s)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n0, t0 = metric_total("llm_prefills_total"), time.perf_counter()
            time.sleep(SERVE_PROFILE_S)
            window_ms = (time.perf_counter() - t0) * 1e3
            prefills = metric_total("llm_prefills_total") - n0
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        if (prefills > 0 and rows) or not t.is_alive():
            break
    t.join()
    if "error" in out:
        raise out["error"]
    return {"concurrency": concurrency, "requests": n_requests,
            "result": out["cell"], "windows": attempt,
            "window_ms": window_ms, "window_prefills": prefills,
            "device_busy_ms": sum(r[1] for r in rows),
            "top": [{"kernel": k[:90], "ms": t_, "count": c}
                    for k, t_, c in rows[:6]]}


def run_serve_bench(report):
    """Routed serving at the serving width (``run_engine``'s model, bf16):
    ``serve_bench.run``'s ladder under the pow-2 and prefix-aware
    routers, then the kill rung with the KV tier off and on, on two
    engines sharing the card, then the profiled rerun of the top
    prefix-aware cell.  Gates: every request of every cell completes
    without an error, the top rung evicts pages under both policies,
    prefix-aware saves prefill tokens, copies COW pages and hits more than
    pow-2, the tier-on kill cell pulls, and the forward kernel launches
    once a layer for every prefill that took ``lm.prefill`` (a full miss;
    a hit's suffix takes ``lm.prefill_with_prefix`` and the plain paged
    attention), both counted over ``serve_bench.run`` alone.  The
    reference's speed comparisons are measured, not gated.  Returns the
    kernel's launches."""
    import statistics
    import threading

    import torch

    from ray_tpu_torch._private import serve_bench as sb
    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.ops import attention

    model = serving_model()
    n_layers = model[1].n_layers
    # count the prefills by path, with each call's host ms (its launches:
    # the logits are read after it returns); the engines call both
    # through the module, from their scheduler threads
    plain = {"kernel": lm.prefill, "suffix": lm.prefill_with_prefix}
    call_ms, lock = {path: [] for path in plain}, threading.Lock()

    def counted(path):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return plain[path](*args, **kwargs)
            finally:
                with lock:
                    call_ms[path].append((time.perf_counter() - t0) * 1e3)
        return call

    t_phase = time.monotonic()
    lm.prefill, lm.prefill_with_prefix = counted("kernel"), counted("suffix")
    attention.flash_forward.launches = 0
    try:
        res = sb.run(model, SERVE_LADDER, SERVE_BENCH_SEED, "cuda")
        torch.cuda.synchronize()
        launches = attention.flash_forward.launches
    finally:
        lm.prefill, lm.prefill_with_prefix = plain["kernel"], plain["suffix"]
    bench_s = time.monotonic() - t_phase
    kernel_prefills = len(call_ms["kernel"])
    c, n = SERVE_LADDER[-1]
    top_cell = res["ladder"][-1]["prefix_aware"]
    prof = serve_busy_share(sb, model, n // 2, c, top_cell["wall_s"] / 16)
    phase_s = time.monotonic() - t_phase

    for row in res["ladder"]:
        for policy in ("pow2", "prefix_aware"):
            cell = row[policy]
            print(f"serve_bench c={row['concurrency']} n={row['requests']} "
                  f"{policy}: {cell['requests']} done, {cell['req_per_s']} "
                  f"req/s, TTFT p50 {cell['ttft_p50_ms']} / p90 "
                  f"{cell['ttft_p90_ms']} ms, e2e p90 {cell['e2e_p90_ms']} "
                  f"ms, evictions {cell['page_evictions']} (cold family "
                  f"{cell['evictions_cold_family']}, hot root forced "
                  f"{cell['evictions_hot_root_forced']}), COW "
                  f"{cell['cow_copies']}, saved "
                  f"{cell['prefill_tokens_saved']}, hit rate "
                  f"{cell['prefix_hit_rate']}, preempted "
                  f"{cell['preempted']}, prefill p50/p90 ms by engine "
                  f"{cell['prefill_ms_p50_p90']}, decisions "
                  f"{cell['decisions']}", flush=True)
    kill = res["kill_rung"]
    for name in ("tier_off", "tier_on"):
        cell = kill[name]
        print(f"serve_bench kill rung {name}: {cell['requests_completed']}"
              f"/{kill['requests']} completed, {cell['errors']} errors, "
              f"{cell['failovers']} failovers, {cell['wall_s']} s, recovery "
              f"{cell['recovery_s']} s, extra prefill tokens "
              f"{cell['extra_prefill_tokens_post_kill']}, pulls "
              f"{cell['kv_pulls']} ({cell['kv_pull_pages']} pages), seals "
              f"{cell['kv_seals']}", flush=True)
    call_p50 = {path: statistics.median(v) if v else None
                for path, v in call_ms.items()}
    print(f"serve_bench prefill calls, host ms a call (launches, before "
          f"the logits are read): through the kernel (bucket 240) p50 "
          f"{fmt_ms(call_p50['kernel'])} over {len(call_ms['kernel'])}, "
          f"suffix after a hit (bucket 16) p50 {fmt_ms(call_p50['suffix'])}"
          f" over {len(call_ms['suffix'])}", flush=True)
    # a window that traced no kernel measured nothing (not an idle card)
    busy_ms, window_ms = prof["device_busy_ms"], prof["window_ms"]
    traced = bool(prof["top"]) and prof["window_prefills"] > 0
    prof["busy_share_profiled"] = busy_ms / window_ms if traced else None
    prof["device_ms_per_prefill"] = (busy_ms / prof["window_prefills"]
                                     if traced else None)
    prof["busy_share_top_cell"] = (
        prof["device_ms_per_prefill"] * top_cell["req_per_s"] / 1e3
        if traced else None)
    print(f"serve_bench profiled prefix-aware cell c={prof['concurrency']} "
          f"n={prof['requests']}: {prof['result']['req_per_s']} req/s "
          f"under the profiler; in window {prof['windows']}, "
          f"{window_ms:.1f} ms, the card was busy "
          f"{busy_ms:.1f} ms over {prof['window_prefills']:g} prefills = "
          + fmt_ms(prof["device_ms_per_prefill"]) + " device ms a prefill;"
          " busy share " + ("not measured" if not traced else
                            f"{prof['busy_share_profiled']:.3f} under the "
                            f"profiler, {prof['busy_share_top_cell']:.3f} at "
                            f"the unprofiled top cell's "
                            f"{top_cell['req_per_s']} req/s")
          + "; top: " + "; ".join(f"{r['kernel'][:40]} {r['ms']:.1f} ms "
                                  f"x{r['count']}" for r in prof["top"][:4]),
          flush=True)
    print(f"serve_bench acceptance (the reference's, computed here): "
          f"{res['acceptance']}", flush=True)
    print(f"serve_bench: flash forward launches {launches} over "
          f"{kernel_prefills} kernel-path prefills; bench "
          f"{bench_s:.1f} s, phase {phase_s:.1f} s", flush=True)
    res.update({"phase_s": phase_s, "bench_s": bench_s,
                "kernel_prefills": kernel_prefills,
                "flash_launches": launches,
                "prefill_calls": {p: len(v) for p, v in call_ms.items()},
                "prefill_call_p50_ms": call_p50, "profiled_cell": prof})
    report["serve_bench"] = res

    top_row = res["ladder"][-1]
    cells = [(row["concurrency"], p, row[p]["requests"], row["requests"])
             for row in res["ladder"] for p in ("pow2", "prefix_aware")]
    cells.append((prof["concurrency"], "profiled",
                  prof["result"]["requests"], prof["requests"]))
    short = [x for x in cells if x[2] != x[3]]
    if short:
        raise SystemExit(f"serve_bench cells left requests undone: {short}")
    if not all(kill[k]["errors"] == 0
               and kill[k]["requests_completed"] == kill["requests"]
               for k in ("tier_off", "tier_on")):
        raise SystemExit("the kill rung failed or wedged requests")
    if not (top_row["pow2"]["page_evictions"] > 0
            and top_row["prefix_aware"]["page_evictions"] > 0):
        raise SystemExit("the top rung never reached the load wall")
    aware = top_row["prefix_aware"]
    if not (aware["prefill_tokens_saved"] > 0 and aware["cow_copies"] > 0):
        raise SystemExit("prefix-aware saved no prefill or copied no page")
    if not aware["prefix_hit_rate"] > top_row["pow2"]["prefix_hit_rate"]:
        raise SystemExit("prefix-aware routing hit no more than pow-2")
    if kill["tier_on"]["kv_pulls"] < 1:
        raise SystemExit("the tier-on kill cell pulled no spine")
    if not (launches > 0 and launches == n_layers * kernel_prefills):
        raise SystemExit(f"flash forward launches {launches} != "
                         f"{n_layers} x {kernel_prefills} kernel-path "
                         f"prefills")
    return launches


# The trainer's first step through the kernels against the same step
# through the plain attention, in bf16.  The two attentions' outputs and
# gradients differ by single bf16 roundings that average out over 12288
# tokens: the mean loss (~ln 50257 = 10.8) within 1e-3, the pre-clip
# global grad norm within 1% of its value.
STEP_LOSS_TOL, STEP_NORM_RTOL = 1e-3, 1e-2
BATCH, SEQ = 12, 1024  # bench.py's headline trainer


def run_trainer(report):
    """``bench.py``'s GPT-2 124M train step at full width on the card.
    Returns the kernels' launch counts over the counted, timed steps."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)  # bench.py main()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params0 = gpt2.init(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in train.tree_leaves(params0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ + 1),
                           generator=gen, device="cuda")

    def fresh(opt):
        params = train.tree_map(torch.clone, params0)
        return {"params": params, "opt_state": opt.init(params), "step": 0}

    # (a) the first step through the kernels and through the plain attention
    opt = train.default_optimizer(warmup_steps=1)
    first = {}
    for impl in ("plain", "flash"):
        state = fresh(opt)
        step = train.make_train_step(gpt2, cfg, opt, attn_impl=impl)
        state, m = step(state, tokens)
        first[impl] = {"loss": m["loss"].item(),
                       "grad_norm": m["grad_norm"].item()}
        if impl == "plain":
            del state, step, m
            torch.cuda.empty_cache()
    d_loss = abs(first["flash"]["loss"] - first["plain"]["loss"])
    d_norm = abs(first["flash"]["grad_norm"] - first["plain"]["grad_norm"])
    ok_a = (d_loss <= STEP_LOSS_TOL
            and d_norm <= STEP_NORM_RTOL * first["plain"]["grad_norm"]
            and math.isfinite(first["flash"]["loss"]))
    print(f"trainer first step, kernels vs plain attention: loss "
          f"{first['flash']['loss']:.6f} vs {first['plain']['loss']:.6f} "
          f"(diff {d_loss:.3e}, tol {STEP_LOSS_TOL:.0e}); grad norm "
          f"{first['flash']['grad_norm']:.6f} vs "
          f"{first['plain']['grad_norm']:.6f} (diff {d_norm:.3e}, tol "
          f"{STEP_NORM_RTOL:.0%}); ln(vocab) {math.log(cfg.vocab_size):.4f}",
          flush=True)
    if not ok_a:
        raise SystemExit("the first train step through the kernels disagrees")

    # (c) the loss falls on one repeated batch (warmup 1: the first update
    # has lr 0, the next ones the peak rate)
    losses = [first["flash"]["loss"]]
    for _ in range(4):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    print("trainer repeated batch, loss per step: "
          + ", ".join(f"{x:.4f}" for x in losses), flush=True)
    if not (losses[-1] < losses[0] and all(map(math.isfinite, losses))):
        raise SystemExit("the loss did not fall on a repeated batch")
    del state, step, m, params0
    torch.cuda.empty_cache()

    # (b) and the timing: bench.py's optimizer, warm-up, then counted steps
    opt = train.default_optimizer()
    state = train.create_train_state(gpt2, cfg, opt, gen, device="cuda")
    step = train.make_train_step(gpt2, cfg, opt)
    for _ in range(2):
        state, m = step(state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    zero_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    per_step = []  # each kernel's launches in each step (host counters)
    start.record()
    for _ in range(n_steps):
        before = launch_counts()
        state, m = step(state, tokens)
        per_step.append({k: n - before[k] for k, n in launch_counts().items()})
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    step_ms = start.elapsed_time(end) / n_steps
    peak_bytes = torch.cuda.max_memory_allocated()
    tok_s = BATCH * SEQ / (step_ms / 1e3)
    tflops = tok_s * 6 * n_params / 1e12  # bench.py's count (6 P / token)
    final_loss = m["loss"].item()
    want = {k: cfg.n_layers for k in launches}
    print(f"trainer GPT-2 124M (this card): {n_params} params, batch "
          f"{BATCH} x seq {SEQ}, {n_steps} steps: {step_ms:.3f} ms per step "
          f"(host {wall / n_steps * 1e3:.3f} ms), {tok_s:.1f} tokens/s, "
          f"model {tflops:.3f} TFLOP/s = {tflops / 989:.4f} of 989 TFLOP/s; "
          f"peak allocated {peak_bytes / 2**30:.3f} GiB; loss {final_loss:.4f}"
          f"; launches {launches}", flush=True)
    if any(d != want for d in per_step):
        raise SystemExit(f"kernel launches per trainer step {per_step}, want "
                         f"{want} in each")
    if not math.isfinite(final_loss):
        raise SystemExit("the trainer's loss is not finite")

    # where one step's device time goes (outside the counted run)
    rows = device_events(lambda: step(state, tokens))
    busy = sum(r[1] for r in rows)
    profiled = kernel_counts(rows, (*BF16_KERNELS.values(), *SCALAR_KERNELS))
    attn_ms = {k: sum(t for name, t, _ in rows if k in name)
               for k in BF16_KERNELS.values()}
    print(f"trainer step device busy {busy:.3f} ms of {step_ms:.3f} ms "
          f"(idle share {1 - busy / step_ms:.3f}); kernel launches in the "
          f"profiled step {profiled}, their device ms "
          + ", ".join(f"{k} {t:.3f}" for k, t in attn_ms.items())
          + "; top: " + "; ".join(
              f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in rows[:8]),
          flush=True)
    want_profiled = {**{k: cfg.n_layers for k in BF16_KERNELS.values()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    if profiled != want_profiled:
        raise SystemExit(f"the profiled trainer step launched {profiled}, "
                         f"want {want_profiled}")
    report["trainer"] = {
        "n_params": n_params, "batch": BATCH, "seq": SEQ, "steps": n_steps,
        "first_step": first, "repeated_batch_losses": losses,
        "step_ms": step_ms, "host_step_ms": wall / n_steps * 1e3,
        "tokens_per_s": tok_s, "model_tflops": tflops,
        "peak_share_989": tflops / 989, "max_memory_allocated": peak_bytes,
        "final_loss": final_loss, "launches": launches,
        "device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
        "profiled_kernel_launches": profiled,
        "profiled_kernel_ms": attn_ms,
        "top": [{"kernel": k[:90], "ms": t, "count": c}
                for k, t, c in rows[:12]]}
    return launches


# The user's loop (``run_torch_trainer``): run_trainer's GPT-2 124M step fed
# through TorchTrainer and the data iterator.  3 warm-up steps, then the
# timed ones; every batch of the dataset is consumed once.
TORCH_TRAINER_SEED = 17
TORCH_TRAINER_WARMUP, TORCH_TRAINER_TIMED = 3, 24
H2D_BLOCK_BYTES = 64 << 20  # the large copy beside one batch's


def torch_trainer_loop(config):
    """``run_torch_trainer``'s train function, in the trainer's worker: the
    GPT-2 124M step over ``get_dataset_shard("train").iter_torch_batches``
    onto the worker's GPU.  Reports the losses, each ``next(batch)``
    wait, the timed steps' device time, whether each batch's copy had
    completed when the step before it ended, a checksum of the token ids
    consumed, and the worker's kernel launches over the loop (its counters
    are its own process's)."""
    import hashlib

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(train.get_context().get_device())
    cfg = config["cfg"]
    opt = train_step.default_optimizer(warmup_steps=1)
    gen = torch.Generator(device=device).manual_seed(config["seed"])
    state = train_step.create_train_state(gpt2, cfg, opt, gen, device=device)
    step = train_step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    warmup, n_steps = config["warmup"], config["warmup"] + config["timed"]
    batches = iter(train.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], drop_last=True, device=device))
    timed = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, waits, copied, ends, kept = [], [], [], [], []
    zero_launch_counts()
    for i in range(n_steps):
        if i == warmup:
            torch.cuda.synchronize(device)
            timed[0].record()
        t0 = time.perf_counter()
        batch = next(batches)
        waits.append((time.perf_counter() - t0) * 1e3)
        kept.append(batch["tokens"])
        copied.append(batch.copied)
        state, m = step(state, batch["tokens"].long())
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        losses.append(m["loss"])
    timed[1].record()
    torch.cuda.synchronize(device)
    launches = launch_counts()
    exhausted = next(batches, None) is None
    rows = torch.cat(kept).cpu().numpy()
    # batch N + 1's copy against the end of the step on batch N (device
    # clocks): at or before it, the copy hid under the step
    hidden = [ends[n].elapsed_time(copied[n + 1]) <= 0
              for n in range(warmup, n_steps - 1)]
    step_ms = timed[0].elapsed_time(timed[1]) / config["timed"]
    train.report({
        "losses": [float(x) for x in losses], "wait_ms": waits,
        "step_ms": step_ms,
        "tokens_per_s": config["batch"] * (rows.shape[1] - 1)
        / (step_ms / 1e3),
        "hidden_share": sum(hidden) / len(hidden), "hidden": hidden,
        "rows": rows.shape[0], "exhausted": exhausted,
        "rows_sha256": hashlib.sha256(rows.tobytes()).hexdigest(),
        "launches": launches, "device": torch.cuda.get_device_name(device)})


def h2d_gbps(nbytes: int, pinned: bool, iters: int) -> float:
    """Host-to-device GB/s of one ``nbytes`` copy from pinned or pageable
    host memory (CUDA events around ``iters`` copies)."""
    import torch

    src = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pinned)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dst.copy_(src, non_blocking=pinned), iters)
    return nbytes / (ms / 1e3) / 1e9


def run_torch_trainer(report):
    """The user's loop on the card: ``TorchTrainer`` at one GPU worker
    (NCCL at world size 1) over ``from_numpy`` token rows, read through
    ``iter_torch_batches`` onto the card into ``run_trainer``'s GPT-2 124M
    step (``torch_trainer_loop``).  Fails unless the loss is finite and
    falls, the rows consumed are the source's in order, the worker's first
    loss equals this process's own step on the same parameters and first
    rows within ``STEP_LOSS_TOL``, and every kernel launched 12 times a
    step in the worker.  Also reads one batch's and a 64 MB block's H2D
    GB/s, pinned and pageable.  Returns the worker's launches."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import data, train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)  # run_trainer's
    n_steps = TORCH_TRAINER_WARMUP + TORCH_TRAINER_TIMED
    tokens = np.random.default_rng(TORCH_TRAINER_SEED).integers(
        0, cfg.vocab_size, (n_steps * BATCH, SEQ + 1)).astype(np.int32)
    config = {"cfg": cfg, "seed": TORCH_TRAINER_SEED, "batch": BATCH,
              "warmup": TORCH_TRAINER_WARMUP, "timed": TORCH_TRAINER_TIMED}
    os.makedirs(OUT_DIR, exist_ok=True)
    storage = tempfile.mkdtemp(dir=OUT_DIR)
    t0 = time.monotonic()
    try:
        result = train.TorchTrainer(
            torch_trainer_loop, train_loop_config=config,
            torch_config=train.TorchConfig(),
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="torch_trainer",
                                       storage_path=storage),
            datasets={"train": data.from_numpy(tokens, column="tokens")},
        ).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.monotonic() - t0
    if result.error is not None:
        raise SystemExit(f"the TorchTrainer loop failed: {result.error}")
    m = result.metrics

    # this process's own first step on the same parameters and rows
    gen = torch.Generator(device="cuda").manual_seed(TORCH_TRAINER_SEED)
    opt = train_step.default_optimizer(warmup_steps=1)
    state = train_step.create_train_state(gpt2, cfg, opt, gen, device="cuda")
    step = train_step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    _, first = step(state, torch.from_numpy(tokens[:BATCH]).cuda().long())
    own_loss = first["loss"].item()
    del state, step, first
    torch.cuda.empty_cache()

    batch_bytes = BATCH * (SEQ + 1) * tokens.itemsize
    h2d = {f"{label}_{kind}": h2d_gbps(nbytes, kind == "pinned", iters)
           for label, nbytes, iters in (("batch", batch_bytes, 200),
                                        ("block", H2D_BLOCK_BYTES, 20))
           for kind in ("pinned", "pageable")}
    waits = np.asarray(m["wait_ms"][TORCH_TRAINER_WARMUP:])
    ratio = m["tokens_per_s"] / report["trainer"]["tokens_per_s"]
    losses = m["losses"]
    want = {k: cfg.n_layers * n_steps for k in m["launches"]}
    source_sha = hashlib.sha256(tokens.tobytes()).hexdigest()
    print(f"torch trainer (this card, {m['device']}): TorchTrainer, 1 NCCL "
          f"worker, {n_steps} steps of GPT-2 124M over iter_torch_batches "
          f"({fit_s:.1f} s for fit): loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}; this process's own first step "
          f"{own_loss:.6f} (diff {abs(losses[0] - own_loss):.3e}, tol "
          f"{STEP_LOSS_TOL:.0e}); {m['step_ms']:.3f} ms a timed step, "
          f"{m['tokens_per_s']:.1f} tokens/s = {ratio:.4f} of run_trainer's "
          f"{report['trainer']['tokens_per_s']:.1f}; next(batch) wait p50 "
          f"{np.percentile(waits, 50):.4f} ms p90 "
          f"{np.percentile(waits, 90):.4f} ms; copy done before the step "
          f"on the batch before it ended: {m['hidden_share']:.3f} of "
          f"{len(m['hidden'])}; rows {m['rows']} (sha256 "
          f"{'equal to' if m['rows_sha256'] == source_sha else 'UNLIKE'} "
          f"the source's); H2D GB/s one batch ({batch_bytes} B) pinned "
          f"{h2d['batch_pinned']:.3f} pageable {h2d['batch_pageable']:.3f}, "
          f"64 MB pinned {h2d['block_pinned']:.3f} pageable "
          f"{h2d['block_pageable']:.3f}; worker launches {m['launches']}",
          flush=True)
    report["torch_trainer"] = dict(
        m, fit_s=fit_s, own_first_loss=own_loss, tokens_per_s_ratio=ratio,
        wait_ms_p50=float(np.percentile(waits, 50)),
        wait_ms_p90=float(np.percentile(waits, 90)), h2d_gbps=h2d,
        batch_bytes=batch_bytes, source_sha256=source_sha)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"the loop's loss is not finite and falling: "
                         f"{losses}")
    if not (m["rows_sha256"] == source_sha and m["exhausted"]
            and m["rows"] == len(tokens)):
        raise SystemExit("the rows the loop consumed are not the source's")
    if abs(losses[0] - own_loss) > STEP_LOSS_TOL:
        raise SystemExit("the worker's first loss disagrees with this "
                         "process's step on the same parameters and rows")
    if m["launches"] != want:
        raise SystemExit(f"worker launches {m['launches']}, want {want}")
    return m["launches"]


# Mixtral 8x7B's widths (MoEConfig.mixtral_8x7b()) cut to one layer; one
# sequence of 4096 tokens.  State costs 16 B a parameter (the f32 weight,
# its gradient, Adam's two moments) and the update three more f32
# temporaries (m_hat, denom, u): 28 B in all.  Two layers would need 88.6 GB
# of it, more than the card's 80 GB.
MOE_LAYERS, MOE_BATCH, MOE_SEQ = 1, 1, 4096
MOE_BYTES_PER_PARAM = 28
# the aux loss through the kernels against the plain attention's: one bf16
# ulp in the attention can flip a near-tied token's top choice, which
# moves aux by ~E * p_e / tokens (~2.4e-4 here); 1% allows ~40 flips
MOE_AUX_RTOL = 0.01
# A token routed alike by both forwards (same experts, same capacity
# verdicts) has logits within APPLY_TOL; one routed otherwise gets other
# experts' outputs and logits unrelated to the other forward's, so the
# logits are compared on the tokens routed alike, and the share routed
# otherwise is bounded: at most 1.3% of 4096 tokens in the CPU emulation
# of the kernels' rounding (24-29 tokens with other experts and 8-24 with
# other capacity verdicts, three seeds), 3% with a margin.
MOE_REROUTED_MAX = 0.03
# The MoE's first step through the kernels against the plain attention's.
# A bf16 ulp in the attention output moves near-tied tokens across the
# router's top-2 cut, and a token sent to another expert changes its CE by
# O(1): in the CPU emulation of the kernels' rounding at a Mixtral-shaped
# cut (tests/test_torch_attention_tc_numerics.py) 8-10 of 1024 tokens
# moved and the mean loss by up to 2.3e-3, 24-29 of 4096 tokens and up to
# 7.3e-4 (three seeds each), past the GPT-2 trainer's 1e-3.  The grad norm
# moved by at most 5.2e-4 of its value, inside STEP_NORM_RTOL.
MOE_STEP_LOSS_TOL = 5e-3


def moe_param_counts(cfg):
    """Parameters of the MoE model by part, and those one token's forward
    uses: attention, the router, k/E of the experts and the LM head (6 x
    that per token is the model FLOP count; the dense dispatch and
    combine, the capacity padding and attention's s^2 term are not
    counted, as ``bench.py`` counts none of them)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    router = d * cfg.n_experts
    experts = 3 * cfg.n_experts * d * cfg.d_ff
    norms = 2 * d
    per_layer = attn + router + experts + norms
    embed = head = cfg.vocab_size * d
    total = cfg.n_layers * per_layer + embed + head + d
    active = (cfg.n_layers * (attn + router + experts
                              * cfg.experts_per_token // cfg.n_experts)
              + head)
    return {"attention": attn, "router": router, "experts": experts,
            "per_layer": per_layer, "embed_and_head": embed + head,
            "total": total, "active_per_token": active}


def moe_drop_share(cfg, h, router_w):
    """Share of (token, choice) pairs over their expert's capacity, from
    the routing of h (n, d), in plain torch: top-k of the f32 router
    softmax, each choice's position in its expert's buffer, first choices
    before second ones."""
    import torch

    from ray_tpu_torch.models import moe

    probs = torch.softmax(h.float() @ router_w.float(), dim=-1)
    top = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
    chosen = top.t().reshape(-1)  # choice-major
    onehot = torch.nn.functional.one_hot(chosen, cfg.n_experts)
    before = (onehot.cumsum(dim=0) - onehot).gather(1, chosen[:, None])
    cap = moe.expert_capacity(cfg, h.shape[0])
    return float((before >= cap).float().mean())


def run_moe_trainer(report):
    """The Mixtral MoE trainer on the card at Mixtral 8x7B's widths, one
    layer, batch 1 x seq 4096: logits against the plain attention, the
    first step against the plain attention, the loss falling, timed and
    profiled steps with their launches, and the step on a world-size-1
    mesh through the zigzag dispatch.  Returns the kernels' launches over
    the counted, timed steps."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama, moe
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.train import step as train

    cfg = dataclasses.replace(moe.MoEConfig.mixtral_8x7b(),
                              n_layers=MOE_LAYERS)
    counts = moe_param_counts(cfg)
    n_params, n_tok = counts["total"], MOE_BATCH * MOE_SEQ
    two = moe_param_counts(dataclasses.replace(cfg, n_layers=2))["total"]
    print(f"moe trainer: Mixtral 8x7B widths, {cfg.n_layers} layer: "
          f"{n_params} params ({counts['per_layer']} a layer, experts "
          f"{counts['experts']}, embed + head {counts['embed_and_head']}); "
          f"state and update at {MOE_BYTES_PER_PARAM} B a param "
          f"{n_params * MOE_BYTES_PER_PARAM / 1e9:.1f} GB (2 layers "
          f"{two * MOE_BYTES_PER_PARAM / 1e9:.1f} GB)", flush=True)

    def gen(offset=0):
        return torch.Generator(device="cuda").manual_seed(6 + offset)

    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1),
                           generator=gen(100), device="cuda")

    def fresh(opt):  # the same weights every time: init from one seed
        params = moe.init(cfg, gen(), device="cuda")
        return {"params": params, "opt_state": opt.init(params), "step": 0}

    # (a) the forward through the kernels against the plain attention on
    # the tokens both route alike, and the share of choices dropped by
    # capacity in the layer
    params = moe.init(cfg, gen(), device="cuda")
    inp = tokens[:, :-1]
    with torch.inference_mode():
        before = attention.flash_forward.launches
        flash, aux = moe.apply(params, inp, cfg, return_aux=True)
        launched = attention.flash_forward.launches - before
        plain, aux_plain = moe.apply(params, inp, cfg, attn_impl="plain",
                                     return_aux=True)
        p0 = llama.layer_params(params["layers"], 0)
        routes = {}
        for impl in ("flash", "plain"):  # the layer's input, and its routing
            x = llama._attention_block(
                cfg, params["embed"][inp].to(torch.bfloat16), p0,
                llama._positions(MOE_SEQ, None, inp.device),
                llama._attention(impl))
            h = llama.rms_norm(x, p0["mlp_norm"], cfg.norm_eps).reshape(
                -1, cfg.d_model)
            routes[impl] = moe.route(cfg, h, p0["router"])
        dropped = moe_drop_share(cfg, h, p0["router"])
    kept = routes["plain"]["keep"]
    alike = ((routes["flash"]["top_idx"] == routes["plain"]["top_idx"])
             & (routes["flash"]["keep"] == kept)).all(dim=-1)
    rerouted = 1 - float(alike.float().mean())
    err = float((flash - plain).reshape(-1, cfg.vocab_size)[alike].abs()
                .max())
    scale = float(plain.abs().max())
    tol = APPLY_TOL * max(1.0, scale)
    d_aux = abs(float(aux) - float(aux_plain))
    print(f"moe.apply Mixtral widths bf16, s{MOE_SEQ}: tokens routed "
          f"otherwise {rerouted:.4f} (max {MOE_REROUTED_MAX}); logits of the "
          f"rest max abs diff {err:.4e} (tol {tol:.3e}, max |logit| "
          f"{scale:.3f}); aux {float(aux):.6f} vs {float(aux_plain):.6f} (tol "
          f"{MOE_AUX_RTOL:.0%}); kernel launches {launched}; choices "
          f"dropped by capacity {dropped:.4f} (route: "
          f"{1 - float(kept.float().mean()):.4f})", flush=True)
    if not (err <= tol and rerouted <= MOE_REROUTED_MAX
            and bool(torch.isfinite(flash).all())
            and launched == cfg.n_layers
            and d_aux <= MOE_AUX_RTOL * abs(float(aux_plain))
            and abs(dropped - (1 - float(kept.float().mean()))) < 1e-9):
        raise SystemExit("moe.apply through the kernels disagrees")
    del params, flash, plain, x, h, p0, routes
    torch.cuda.empty_cache()

    # (b) the first step through the kernels and through the plain one
    opt = train.default_optimizer(warmup_steps=1)
    first = {}
    for impl in ("plain", "flash"):
        state = fresh(opt)
        step = train.make_train_step(moe, cfg, opt, attn_impl=impl)
        state, m = step(state, tokens)
        first[impl] = {"loss": m["loss"].item(),
                       "grad_norm": m["grad_norm"].item()}
        if impl == "plain":
            del state, step, m
            torch.cuda.empty_cache()
    d_loss = abs(first["flash"]["loss"] - first["plain"]["loss"])
    d_norm = abs(first["flash"]["grad_norm"] - first["plain"]["grad_norm"])
    print(f"moe trainer first step, kernels vs plain attention: loss "
          f"{first['flash']['loss']:.6f} vs {first['plain']['loss']:.6f} "
          f"(diff {d_loss:.3e}, tol {MOE_STEP_LOSS_TOL:.0e}); grad norm "
          f"{first['flash']['grad_norm']:.6f} vs "
          f"{first['plain']['grad_norm']:.6f} (diff {d_norm:.3e}, tol "
          f"{STEP_NORM_RTOL:.0%}); ln(vocab) {math.log(cfg.vocab_size):.4f}",
          flush=True)
    if not (d_loss <= MOE_STEP_LOSS_TOL
            and d_norm <= STEP_NORM_RTOL * first["plain"]["grad_norm"]
            and math.isfinite(first["flash"]["loss"])):
        raise SystemExit("the first MoE step through the kernels disagrees")

    # (c) the loss falls on the repeated batch
    losses = [first["flash"]["loss"]]
    for _ in range(4):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    print("moe trainer repeated batch, loss per step: "
          + ", ".join(f"{x:.4f}" for x in losses), flush=True)
    if not (losses[-1] < losses[0] and all(map(math.isfinite, losses))):
        raise SystemExit("the MoE loss did not fall on a repeated batch")
    del state, step, m
    torch.cuda.empty_cache()

    # (d) timed steps: bench.py's optimizer, warm-up, then counted steps
    opt = train.default_optimizer()
    state = train.create_train_state(moe, cfg, opt, gen(), device="cuda")
    step = train.make_train_step(moe, cfg, opt)
    for _ in range(2):
        state, m = step(state, tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    zero_launch_counts()
    per_step = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_steps):
        before = launch_counts()
        state, m = step(state, tokens)
        per_step.append({k: n - before[k] for k, n in launch_counts().items()})
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    step_ms = start.elapsed_time(end) / n_steps
    peak_bytes = torch.cuda.max_memory_allocated()
    tok_s = n_tok / (step_ms / 1e3)
    tflops = tok_s * 6 * counts["active_per_token"] / 1e12
    final_loss = m["loss"].item()
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers}
    print(f"moe trainer Mixtral widths x {cfg.n_layers} layer (this card): "
          f"batch {MOE_BATCH} x seq {MOE_SEQ}, {n_steps} steps: {step_ms:.3f}"
          f" ms per step (host {wall / n_steps * 1e3:.3f} ms), {tok_s:.1f} "
          f"tokens/s, model {tflops:.3f} TFLOP/s = {tflops / 989:.4f} of 989 "
          f"TFLOP/s (6 x {counts['active_per_token']} active params a "
          f"token: attention + router + k/E experts + LM head); peak "
          f"allocated {peak_bytes / 1e9:.3f} GB (reckoned "
          f"{n_params * MOE_BYTES_PER_PARAM / 1e9:.1f} GB of state and "
          f"update); loss {final_loss:.4f}; launches {launches}", flush=True)
    if any(d != want for d in per_step):
        raise SystemExit(f"kernel launches per MoE step {per_step}, want "
                         f"{want} in each")
    if not math.isfinite(final_loss):
        raise SystemExit("the MoE trainer's loss is not finite")

    # (e) where one step's device time goes (outside the counted run)
    rows = device_events(lambda: step(state, tokens))
    busy = sum(r[1] for r in rows)
    profiled = kernel_counts(rows, (*BF16_KERNELS.values(), *SCALAR_KERNELS))
    attn_ms = {k: sum(t for name, t, _ in rows if k in name)
               for k in BF16_KERNELS.values()}
    print(f"moe trainer step device busy {busy:.3f} ms of {step_ms:.3f} ms "
          f"(idle share {1 - busy / step_ms:.3f}); kernel launches in the "
          f"profiled step {profiled}, their device ms "
          + ", ".join(f"{k} {t:.3f}" for k, t in attn_ms.items())
          + "; top: " + "; ".join(
              f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in rows[:8]),
          flush=True)
    want_profiled = {**{BF16_KERNELS[k]: n for k, n in want.items()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    if profiled != want_profiled:
        raise SystemExit(f"the profiled MoE step launched {profiled}, want "
                         f"{want_profiled}")
    del state, step, m
    torch.cuda.empty_cache()

    # (f) the mesh on the card: a world-size-1 NCCL group and the zigzag
    # dispatch, which at sp 1 is the flash kernels: the first step's loss
    # equals (b)'s bit for bit
    os.makedirs(OUT_DIR, exist_ok=True)
    store_dir = tempfile.mkdtemp(dir=OUT_DIR)
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = create_mesh(MeshConfig())
            opt = train.default_optimizer(warmup_steps=1)
            state = fresh(opt)
            step = train.make_train_step(moe, cfg, opt, attn_impl="zigzag",
                                         mesh=mesh)
            before = launch_counts()
            state, m = step(state, tokens)
            mesh_loss = m["loss"].item()
            mesh_launches = {k: n - before[k]
                             for k, n in launch_counts().items()}
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"moe trainer on create_mesh(MeshConfig()) (world size 1, NCCL), "
          f"attn_impl zigzag: first-step loss {mesh_loss:.6f} vs "
          f"{first['flash']['loss']:.6f} without the mesh; launches "
          f"{mesh_launches}", flush=True)
    if mesh_loss != first["flash"]["loss"] or mesh_launches != want:
        raise SystemExit("the MoE step on the mesh differs from the step "
                         "without it")
    del state, step, m
    torch.cuda.empty_cache()

    report["moe_trainer"] = {
        "layers": cfg.n_layers, "param_counts": counts,
        "reckoned_state_bytes": n_params * MOE_BYTES_PER_PARAM,
        "reckoned_state_bytes_2_layers": two * MOE_BYTES_PER_PARAM,
        "batch": MOE_BATCH, "seq": MOE_SEQ, "steps": n_steps,
        "apply_logit_err": err, "apply_logit_tol": tol,
        "apply_rerouted_share": rerouted,
        "aux": float(aux), "aux_plain": float(aux_plain),
        "dropped_share": dropped, "first_step": first,
        "repeated_batch_losses": losses, "step_ms": step_ms,
        "host_step_ms": wall / n_steps * 1e3, "tokens_per_s": tok_s,
        "model_tflops": tflops, "peak_share_989": tflops / 989,
        "max_memory_allocated": peak_bytes, "final_loss": final_loss,
        "launches": launches, "device_busy_ms": busy,
        "idle_share": 1 - busy / step_ms,
        "profiled_kernel_launches": profiled,
        "profiled_kernel_ms": attn_ms, "mesh_first_loss": mesh_loss,
        "top": [{"kernel": k[:90], "ms": t, "count": c}
                for k, t, c in rows[:12]]}
    return launches


# Llama-3 8B's widths (LlamaConfig.llama3_8b()) cut to four layers, at the
# recipe's batch 2 x seq 8192 on a one-card mesh.  The step's state and
# update cost 28 B a parameter, as the MoE's: 32 layers would need ~225 GB,
# 6 layers 66 GB (~76 GB with the bf16 casts and the remat activations).  A
# checkpoint holds the f32 weights and both moments, 12 B a parameter.
LLAMA3_LAYERS, LLAMA3_BATCH, LLAMA3_SEQ = 4, 2, 8192
LLAMA3_BYTES_PER_PARAM = 28
LLAMA3_CKPT_BYTES_PER_PARAM = 12
LLAMA3_STEPS = 4  # the entry point's: steps 2 and 3 are steady-state
LLAMA3_CKPT_DIRS = ("TMPDIR", "checkout")  # where the checkpoint may go
# The first step through the kernels against the plain attention's: in the
# CPU emulation of the kernels' rounding at Llama-3-shaped cuts (head_dim
# 128, 4:1 GQA, vocab 128256, bf16, remat; 2 layers x 1024 tokens and 4 x
# 2048, five seeds; tests/test_torch_attention_tc_numerics.py) the loss
# moved by at most 4.7e-4 and the grad norm by 2.1e-4 of its value: the
# GPT-2 trainer's tolerances hold.
LLAMA3_STEP_LOSS_TOL = STEP_LOSS_TOL


def llama3_param_counts(cfg):
    """Parameters of the Llama model by part (``llama.init``'s leaves)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * cfg.n_heads * hd * 2 + d * cfg.n_kv_heads * hd * 2
    mlp = 3 * d * cfg.d_ff
    per_layer = attn + mlp + 2 * d
    embed_and_head = 2 * cfg.vocab_size * d
    return {"attention": attn, "mlp": mlp, "per_layer": per_layer,
            "embed_and_head": embed_and_head,
            "total": cfg.n_layers * per_layer + embed_and_head + d}


def chunked_plain_attention():
    """The plain attention (``reference_attention`` and
    ``reference_attention_backward``, the kernels' plain versions) one KV
    head's query group at a time, with that backward as its gradient: at
    the Llama-3 trainer's shape the whole plain attention's f32 scores
    would take 17 GB a tensor.  Each (query, key) pair's math is the plain
    version's.  Returns an ``attn_impl`` callable."""
    import torch

    from ray_tpu_torch.ops import attention

    def chunks(q, k):
        group = q.shape[0] // k.shape[0]
        return [(slice(j * group, (j + 1) * group), slice(j, j + 1))
                for j in range(k.shape[0])]

    class ChunkedPlain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale):
            out = torch.empty_like(q)
            lse = q.new_empty(q.shape[:2], dtype=torch.float32)
            for qs, ks in chunks(q, k):
                out[qs], lse[qs] = attention.reference_attention(
                    q[qs], k[ks], v[ks], causal, scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale = causal, scale
            return out

        @staticmethod
        def backward(ctx, d_out):
            q, k, v, out, lse = ctx.saved_tensors
            d_out = d_out.contiguous()
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            for qs, ks in chunks(q, k):
                dq[qs], dk[ks], dv[ks] = \
                    attention.reference_attention_backward(
                        q[qs], k[ks], v[ks], out[qs], lse[qs], d_out[qs],
                        ctx.causal, ctx.scale)
            return dq, dk, dv, None, None

    def attn(q, k, v, *, causal=True, sm_scale=None):
        return attention._packed_call(ChunkedPlain.apply, q, k, v, causal,
                                      sm_scale)

    return attn


def checkpoint_dir(need: int) -> str:
    """A directory with ``need`` bytes free: the process's temporary
    directory, else the checkout's git-ignored ``_run/``."""
    import shutil
    import tempfile

    free = {}
    for where in LLAMA3_CKPT_DIRS:
        path = (tempfile.gettempdir() if where == "TMPDIR"
                else os.path.join(HERE, "_run"))
        os.makedirs(path, exist_ok=True)
        free[path] = shutil.disk_usage(path).free
        if free[path] >= need:
            print(f"llama3 checkpoint directory {path}: "
                  f"{free[path] / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
                  "needed", flush=True)
            return tempfile.mkdtemp(prefix="llama3_", dir=path)
    raise SystemExit(f"no directory has {need / 1e9:.1f} GB free for the "
                     "Llama-3 checkpoint: " + ", ".join(
                         f"{p} {b / 1e9:.1f} GB" for p, b in free.items()))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def run_llama3_trainer(report):
    """The Llama-3 8B pretraining recipe at Llama-3 8B's widths cut to four
    layers, batch 2 x seq 8192: (a) ``train_llama3_8b`` through
    ``DataParallelTrainer``, the controller and a spawned worker, its
    committed checkpoint and metrics, and a dry-geometry run whose
    checkpoint is restored onto the card; (b) the same step in this
    process on a world-size-1 NCCL mesh (``create_train_state`` /
    ``make_train_step`` with ``mesh``), where the launch counters can be
    read: the first step against the plain attention, the loss falling,
    launches a step, timed and profiled steps.  Returns the kernels'
    launches over (b)'s counted steps."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.train import step as train
    from ray_tpu_torch.train.checkpoint import load_pytree
    from ray_tpu_torch.train.llama3 import train_llama3_8b

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              n_layers=LLAMA3_LAYERS)
    counts = llama3_param_counts(cfg)
    n_params, n_tok = counts["total"], LLAMA3_BATCH * LLAMA3_SEQ
    need_mem = n_params * LLAMA3_BYTES_PER_PARAM
    ckpt_reckoned = n_params * LLAMA3_CKPT_BYTES_PER_PARAM
    six = llama3_param_counts(dataclasses.replace(cfg, n_layers=6))["total"]
    print(f"llama3 trainer: Llama-3 8B widths, {cfg.n_layers} layers: "
          f"{n_params} params ({counts['per_layer']} a layer, embed + head "
          f"{counts['embed_and_head']}); state and update at "
          f"{LLAMA3_BYTES_PER_PARAM} B a param {need_mem / 1e9:.1f} GB (6 "
          f"layers {six * LLAMA3_BYTES_PER_PARAM / 1e9:.1f} GB); checkpoint "
          f"{ckpt_reckoned / 1e9:.1f} GB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"llama3 trainer: {free / 1e9:.2f} GB of {total / 1e9:.2f} GB free "
          "on the card before the worker starts", flush=True)
    if free < need_mem:
        raise SystemExit(f"{free} bytes free on the card, under the "
                         f"{need_mem} the Llama-3 step needs")
    tmp = checkpoint_dir(int(ckpt_reckoned * 1.1))
    out = {"layers": cfg.n_layers, "param_counts": counts,
           "reckoned_state_bytes": need_mem,
           "reckoned_state_bytes_6_layers": six * LLAMA3_BYTES_PER_PARAM,
           "reckoned_checkpoint_bytes": ckpt_reckoned,
           "batch": LLAMA3_BATCH, "seq": LLAMA3_SEQ}
    try:
        # (a) the entry point, in a spawned worker
        t0 = time.monotonic()
        result = train_llama3_8b(
            num_workers=1, steps=LLAMA3_STEPS, n_layers=LLAMA3_LAYERS,
            mesh={"fsdp": 1, "tp": 1}, storage_path=os.path.join(tmp, "full"))
        fit_s = time.monotonic() - t0
        if result.error is not None:
            raise SystemExit(f"train_llama3_8b failed: {result.error}")
        m = result.metrics
        ckpt_bytes = dir_bytes(result.checkpoint.path)
        print(f"llama3 train_llama3_8b (this card): {fit_s:.1f} s, step "
              f"{m['step']}, loss {m['loss']:.4f} (ln(vocab) "
              f"{math.log(cfg.vocab_size):.4f}), grad norm "
              f"{m['grad_norm']:.4f}; steady {m['tokens_per_sec']:.1f} "
              f"tokens/s, model {m['model_tflops_per_s']:.3f} TFLOP/s, mfu "
              f"{m['mfu']:.4f} (of 989), first-step bracket "
              f"{m['compile_s']:.2f} s, goodput share "
              f"{m['goodput_fraction']:.3f}; checkpoint {ckpt_bytes} bytes "
              f"on disk ({ckpt_bytes / 1e9:.2f} GB, reckoned "
              f"{ckpt_reckoned / 1e9:.2f} GB), saved in "
              f"{m['checkpoint_s']:.2f} s = "
              f"{m['checkpoint_bytes'] / m['checkpoint_s'] / 1e9:.2f} GB/s",
              flush=True)
        if not (m["step"] == LLAMA3_STEPS and 0 < m["loss"] < 20
                and math.isfinite(m["loss"]) and m["tokens_per_sec"] > 0
                and m["model_tflops_per_s"] and m["mfu"]
                and m["n_params"] == n_params
                and len(result.best_checkpoints) == 1
                and abs(ckpt_bytes / ckpt_reckoned - 1) < 0.02):
            raise SystemExit(f"train_llama3_8b's result is off: {m}")
        out["entry_point"] = dict(m, fit_s=fit_s,
                                  checkpoint_disk_bytes=ckpt_bytes)
        shutil.rmtree(os.path.join(tmp, "full"))
        dry = train_llama3_8b(num_workers=1, dry_run=True, steps=2,
                              ckpt_every=2, seq_len=64,
                              storage_path=os.path.join(tmp, "dry"))
        if dry.error is not None:
            raise SystemExit(f"the dry run failed: {dry.error}")

        # (b) the same step in this process, on a world-size-1 NCCL mesh
        os.makedirs(OUT_DIR, exist_ok=True)
        store_dir = tempfile.mkdtemp(dir=OUT_DIR)
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = create_mesh(MeshConfig(fsdp=1, tp=1), "cuda")
            out.update(_llama3_steps(report, cfg, mesh, n_params, n_tok,
                                     need_mem))
            restored = load_pytree(dry.checkpoint.path, device="cuda")
        finally:
            dist.destroy_process_group()
            shutil.rmtree(store_dir, ignore_errors=True)
        dry_cfg = llama.LlamaConfig.llama3_8b_dry()
        leaves = train.tree_leaves(restored["params"])
        n_dry = sum(t.numel() for t in leaves)
        print(f"llama3 dry checkpoint restored onto the card: {n_dry} params "
              f"(llama3_8b_dry: {llama3_param_counts(dry_cfg)['total']}), "
              f"step {int(restored['step'])}, devices "
              f"{sorted({str(t.device) for t in leaves})}", flush=True)
        if not (n_dry == llama3_param_counts(dry_cfg)["total"]
                and int(restored["step"]) == 2
                and all(t.is_cuda and bool(torch.isfinite(t).all())
                        for t in leaves)):
            raise SystemExit("the dry checkpoint's restore is off")
        out["dry_restore"] = {"n_params": n_dry,
                              "step": int(restored["step"])}
        del restored, leaves
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["llama3_trainer"] = out
    torch.cuda.empty_cache()
    return out["launches"]


def _llama3_steps(report, cfg, mesh, n_params, n_tok, need_mem):
    """Part (b) of ``run_llama3_trainer``."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.train import step as train

    tokens = torch.randint(0, cfg.vocab_size, (LLAMA3_BATCH, LLAMA3_SEQ + 1),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(107), device="cuda")

    def fresh(opt):
        gen = torch.Generator(device="cuda").manual_seed(7)
        return train.create_train_state(llama, cfg, opt, gen, "cuda",
                                        mesh=mesh)

    # the first step through the kernels and through the plain attention
    opt = train.default_optimizer(warmup_steps=1)
    first = {}
    attention.ATTENTION["plain_chunked"] = chunked_plain_attention()
    try:
        for impl in ("plain_chunked", "flash"):
            state = fresh(opt)
            step = train.make_train_step(llama, cfg, opt, attn_impl=impl,
                                         mesh=mesh)
            state, m = step(state, tokens)
            first[impl] = {"loss": m["loss"].item(),
                           "grad_norm": m["grad_norm"].item()}
            if impl == "plain_chunked":
                del state, step, m
                torch.cuda.empty_cache()
    finally:
        del attention.ATTENTION["plain_chunked"]
    plain = first["plain_chunked"]
    d_loss = abs(first["flash"]["loss"] - plain["loss"])
    d_norm = abs(first["flash"]["grad_norm"] - plain["grad_norm"])
    print(f"llama3 trainer first step, kernels vs plain attention: loss "
          f"{first['flash']['loss']:.6f} vs {plain['loss']:.6f} (diff "
          f"{d_loss:.3e}, tol {LLAMA3_STEP_LOSS_TOL:.0e}); grad norm "
          f"{first['flash']['grad_norm']:.6f} vs {plain['grad_norm']:.6f} "
          f"(diff {d_norm:.3e}, tol {STEP_NORM_RTOL:.0%})", flush=True)
    if not (d_loss <= LLAMA3_STEP_LOSS_TOL
            and d_norm <= STEP_NORM_RTOL * plain["grad_norm"]
            and math.isfinite(first["flash"]["loss"])):
        raise SystemExit("the first Llama-3 step through the kernels "
                         "disagrees")

    # the loss falls on the repeated batch
    losses = [first["flash"]["loss"]]
    for _ in range(3):
        state, m = step(state, tokens)
        losses.append(m["loss"].item())
    print("llama3 trainer repeated batch, loss per step: "
          + ", ".join(f"{x:.4f}" for x in losses), flush=True)
    if not (losses[-1] < losses[0] and all(map(math.isfinite, losses))):
        raise SystemExit("the Llama-3 loss did not fall on a repeated batch")

    # counted, timed steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 3
    zero_launch_counts()
    per_step = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_steps):
        before = launch_counts()
        state, m = step(state, tokens)
        per_step.append({k: n - before[k] for k, n in launch_counts().items()})
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    step_ms = start.elapsed_time(end) / n_steps
    peak_bytes = torch.cuda.max_memory_allocated()
    tok_s = n_tok / (step_ms / 1e3)
    tflops = tok_s * 6 * n_params / 1e12  # the recipe's analytic count
    final_loss = m["loss"].item()
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
            "flash_bwd_dq": cfg.n_layers}
    print(f"llama3 trainer Llama-3 8B widths x {cfg.n_layers} layers (this "
          f"card): batch {LLAMA3_BATCH} x seq {LLAMA3_SEQ}, {n_steps} steps: "
          f"{step_ms:.3f} ms per step (host {wall / n_steps * 1e3:.3f} ms), "
          f"{tok_s:.1f} tokens/s, model {tflops:.3f} TFLOP/s = "
          f"{tflops / 989:.4f} of 989 TFLOP/s (6 x {n_params} params a "
          f"token); peak allocated {peak_bytes / 1e9:.3f} GB (reckoned "
          f"{need_mem / 1e9:.1f} GB of state and update); loss "
          f"{final_loss:.4f}; launches {launches}", flush=True)
    if any(d != want for d in per_step):
        raise SystemExit(f"kernel launches per Llama-3 step {per_step}, want "
                         f"{want} in each")
    if not math.isfinite(final_loss):
        raise SystemExit("the Llama-3 trainer's loss is not finite")

    # where one step's device time goes (outside the counted run)
    rows = device_events(lambda: step(state, tokens))
    busy = sum(r[1] for r in rows)
    profiled = kernel_counts(rows, (*BF16_KERNELS.values(), *SCALAR_KERNELS))
    attn_ms = {k: sum(t for name, t, _ in rows if k in name)
               for k in BF16_KERNELS.values()}
    print(f"llama3 trainer step device busy {busy:.3f} ms of {step_ms:.3f} ms"
          f" (idle share {1 - busy / step_ms:.3f}); kernel launches in the "
          f"profiled step {profiled}, their device ms "
          + ", ".join(f"{k} {t:.3f}" for k, t in attn_ms.items())
          + "; top: " + "; ".join(
              f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in rows[:12]),
          flush=True)
    want_profiled = {**{BF16_KERNELS[k]: n for k, n in want.items()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    if profiled != want_profiled:
        raise SystemExit(f"the profiled Llama-3 step launched {profiled}, "
                         f"want {want_profiled}")
    del state, step, m
    torch.cuda.empty_cache()
    return {"first_step": first, "repeated_batch_losses": losses,
            "steps": n_steps, "step_ms": step_ms,
            "host_step_ms": wall / n_steps * 1e3, "tokens_per_s": tok_s,
            "model_tflops": tflops, "peak_share_989": tflops / 989,
            "max_memory_allocated": peak_bytes, "final_loss": final_loss,
            "launches": launches, "device_busy_ms": busy,
            "idle_share": 1 - busy / step_ms,
            "profiled_kernel_launches": profiled,
            "profiled_kernel_ms": attn_ms,
            "top": [{"kernel": k[:90], "ms": t, "count": c}
                    for k, t, c in rows[:20]]}


# --------------------------------------------------------------------------
# Online RLlib (phase 11).  The card's machine has no gymnasium, so the
# phase steps this CartPole; tests/test_torch_rllib_envs.py holds it to
# gymnasium's CartPole-v1 step for step.


class NumpyCartPole:
    """gymnasium's ``CartPole-v1`` in numpy: Euler steps of tau 0.02 s,
    force 10, failure past 12 degrees or 2.4 from the centre, truncation
    at 500 steps (gymnasium's ``TimeLimit``), a reset drawing the state
    uniformly in +-0.05 from ``np.random.default_rng(seed)`` (gymnasium's
    ``np_random``), float32 observations from a float64 state."""

    GRAVITY, MASSCART, MASSPOLE, LENGTH = 9.8, 1.0, 0.1, 0.5
    FORCE_MAG, TAU = 10.0, 0.02
    THETA_THRESHOLD = 12 * 2 * math.pi / 360
    X_THRESHOLD = 2.4
    MAX_STEPS = 500

    def __init__(self):
        import numpy as np

        high = np.array([self.X_THRESHOLD * 2, np.inf,
                         self.THETA_THRESHOLD * 2, np.inf], np.float32)
        self.observation_space = types.SimpleNamespace(
            shape=(4,), low=-high, high=high, dtype=np.float32)
        self.action_space = types.SimpleNamespace(n=2)
        self._rng = np.random.default_rng()
        self._state = None
        self._t = 0
        self._done = False

    def reset(self, *, seed=None, options=None):
        import numpy as np

        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._t, self._done = 0, False
        return self._state.astype(np.float32), {}

    def step(self, action):
        import numpy as np

        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE_MAG if action == 1 else -self.FORCE_MAG
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.MASSPOLE + self.MASSCART
        polemass_length = self.MASSPOLE * self.LENGTH
        temp = (force + polemass_length * np.square(theta_dot) * sintheta
                ) / total_mass
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASSPOLE * np.square(costheta)
                           / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self._state = np.array((x, x_dot, theta, theta_dot), np.float64)
        terminated = bool(x < -self.X_THRESHOLD or x > self.X_THRESHOLD
                          or theta < -self.THETA_THRESHOLD
                          or theta > self.THETA_THRESHOLD)
        reward = 0.0 if self._done else 1.0  # 0 only past a termination
        self._done = self._done or terminated
        self._t += 1
        return (self._state.astype(np.float32), reward, terminated,
                self._t >= self.MAX_STEPS, {})


# tests/test_torch_rllib.py's tolerance for an update, CPU against JAX, of
# the largest magnitude compared (at least 1).  Adam divides by
# sqrt(nu_hat) + 1e-8: an entry whose gradient is near that eps (sqrt(nu_hat)
# above 0 and below RL_ILL) carries the summation order of its gradient
# into its update at full relative size; such parameter entries are held to
# RL_ADAM_TOL instead (ROADMAP §3), and their share is reported.
RL_UPDATE_TOL, RL_ILL, RL_ADAM_TOL = 1e-5, 1e-6, 1e-4


def rl_state_err(got, want, opt_state=None):
    """(the largest |got - want| over the leaves of two trees, each leaf's
    over max(1, its largest |want|); the same over the entries near Adam's
    eps by ``opt_state``, ``want``'s Adam state; their share).  Without
    ``opt_state`` every entry is ordinary."""
    import numpy as np

    from ray_tpu_torch.train.step import tree_leaves

    def arrays(tree):
        return [np.asarray(t.detach().cpu(), np.float64)
                for t in tree_leaves(tree)]

    got, want = arrays(got), arrays(want)
    if opt_state is None:
        ill = [np.zeros(w.shape, bool) for w in want]
    else:
        # an entry whose gradient was always 0 (a head the loss does not
        # use) takes no step on either side: it is ordinary
        corr = 1.0 - 0.999 ** opt_state["count"]
        ill = [(np.sqrt(n / corr) < RL_ILL) & (n > 0)
               for n in arrays(opt_state["nu"])]
    ordinary = soft = 0.0
    for g, w, i in zip(got, want, ill):
        d = np.abs(g - w) / max(1.0, float(np.abs(w).max(initial=0.0)))
        ordinary = max(ordinary, float(d[~i].max(initial=0.0)))
        soft = max(soft, float(d[i].max(initial=0.0)))
    share = sum(int(i.sum()) for i in ill) / max(1, sum(i.size for i in ill))
    return ordinary, soft, share


def rl_update_cases(runner_cls, cartpole, target_match):
    """The recorded inputs of phase 11's update agreement: {name: (fn, its
    CPU inputs)}, where ``fn(inputs, device)`` runs one learner update on
    a copy of the inputs on ``device`` and returns (the trees to compare
    by name, {name of a parameter tree: its Adam state}, which says which
    of its entries are near Adam's eps)."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import dqn, impala, module, multi_agent, ppo
    from ray_tpu_torch.rllib import sac
    from ray_tpu_torch.train.step import ClippedAdam

    def init(obs_dim, n_actions, seed):
        return module.init_mlp(module.MLPConfig(obs_dim, n_actions),
                               torch.Generator().manual_seed(seed), "cpu")

    def on(tree, dev):
        return module.tree_to(tree, dev, copy=True)

    def fresh(params, dev):
        p = on(params, dev)
        return p, ClippedAdam().init(p)

    rng = np.random.default_rng(5)
    params = init(4, 2, 11)
    cases = {}

    # PPO: PPOConfig's defaults, 2 runners x 4 envs x 128 steps, 4 epochs
    # of 4 minibatches of 256, one permutation generator on both sides
    pcfg = ppo.PPOConfig()
    runners = [runner_cls(cartpole, pcfg.num_envs_per_runner, seed=1000 * i)
               for i in range(pcfg.num_env_runners)]
    frags = [r.sample(params, pcfg.rollout_fragment_length)
             for r in runners]

    def ppo_case(inputs, dev):
        p, s = fresh(params, dev)
        batch = ppo.frags_to_batch(inputs, params, pcfg, dev)
        p, s, stats = ppo.ppo_update(
            p, s, batch, torch.Generator().manual_seed(0),
            num_epochs=pcfg.num_epochs, minibatch_size=pcfg.minibatch_size,
            clip=pcfg.clip_param, ent_coeff=pcfg.entropy_coeff,
            vf_coeff=pcfg.vf_loss_coeff, grad_clip=pcfg.grad_clip,
            lr=pcfg.lr)
        return {"params": p, "mu": s["mu"], "nu": s["nu"],
                "stats": list(stats.values())}, {"params": s}

    cases["ppo_update"] = (ppo_case, frags)

    # IMPALA: one fragment of IMPALAConfig's 64 steps x 4 envs
    icfg = impala.IMPALAConfig()
    rollout = runners[0].sample(params, icfg.rollout_fragment_length)

    def impala_case(r, dev):
        p, s = fresh(params, dev)
        cols = {"obs": r["obs"], "actions": r["actions"].astype(np.int64),
                "behavior_logp": r["logp"] - 0.05,  # a stale behavior
                "rewards": r["rewards"] + icfg.gamma * r["trunc_values"],
                "dones": r["dones"].astype(np.float32),
                "last_obs": r["last_obs"]}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        p, s, loss, aux = impala._impala_update(
            p, s, batch, lr=icfg.lr, grad_clip=icfg.grad_clip,
            gamma=icfg.gamma, rho_clip=icfg.vtrace_rho_clip,
            c_clip=icfg.vtrace_c_clip, vf_coeff=icfg.vf_loss_coeff,
            ent_coeff=icfg.entropy_coeff)
        return {"params": p, "mu": s["mu"], "nu": s["nu"],
                "losses": [loss, *aux]}, {"params": s}

    cases["impala_update"] = (impala_case, rollout)

    # DQN: 64 transitions (DQNConfig's train batch) at epsilon 0.5 under
    # importance weights, against a separate target network
    transitions = runners[1].sample_transitions(params, 16, epsilon=0.5)
    transitions["weights"] = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    target = init(4, 2, 12)
    dcfg = dqn.DQNConfig()

    def dqn_case(double_q):
        def run(t, dev):
            p, s = fresh(params, dev)
            batch = {k: torch.from_numpy(
                v.astype(np.int64) if k == "actions" else v).to(dev)
                for k, v in t.items()}
            p, s, loss, td = dqn._dqn_update(
                p, on(target, dev), s, batch, double_q=double_q,
                grad_clip=dcfg.grad_clip, lr=dcfg.lr, gamma=dcfg.gamma)
            return {"params": p, "mu": s["mu"], "nu": s["nu"],
                    "loss": [loss], "td": [td]}, {"params": s}
        return run

    cases["dqn_update_double_q"] = (dqn_case(True), transitions)
    cases["dqn_update_single_q"] = (dqn_case(False), transitions)

    # SAC: 128 transitions (the learning test's train batch) sampled from
    # the softmax policy, SACConfig's rates
    sac_t = runners[0].sample_transitions(params, 32, policy="softmax")
    scfg = sac.SACConfig()
    q0 = {"q1": init(4, 2, 13), "q2": init(4, 2, 14)}
    q_target0 = {"q1": init(4, 2, 15), "q2": init(4, 2, 16)}

    def sac_case(t, dev):
        pi, pi_opt = fresh(params, dev)
        q, q_opt = fresh(q0, dev)
        log_alpha = torch.tensor(float(np.log(scfg.initial_alpha)),
                                 device=dev)
        a_opt = ClippedAdam().init(log_alpha)
        batch = {k: torch.from_numpy(
            v.astype(np.int64) if k == "actions" else v).to(dev)
            for k, v in t.items()}
        out = sac._sac_update(
            pi, q, on(q_target0, dev), log_alpha, pi_opt, q_opt, a_opt,
            batch, gamma=scfg.gamma, tau=scfg.tau, actor_lr=scfg.actor_lr,
            critic_lr=scfg.critic_lr, alpha_lr=scfg.alpha_lr,
            grad_clip=scfg.grad_clip,
            target_entropy=scfg.target_entropy_scale * float(np.log(2)))
        names = ("pi_params", "q_params", "q_target", "log_alpha", "pi_opt",
                 "q_opt", "a_opt", "q_loss", "pi_loss", "entropy")
        trees = dict(zip(names, out))
        adam = {"pi_params": trees["pi_opt"], "q_params": trees["q_opt"],
                "log_alpha": trees["a_opt"]}
        for k in ("pi_opt", "q_opt", "a_opt"):
            trees[k] = {"mu": trees[k]["mu"], "nu": trees[k]["nu"]}
        return trees, adam

    cases["sac_update"] = (sac_case, sac_t)

    # multi-agent PPO: one policy's update on TargetMatchEnv at the
    # learning test's configuration (128 steps, 6 epochs of one minibatch)
    mcfg = multi_agent.MultiAgentPPOConfig(env=target_match, num_epochs=6,
                                           rollout_fragment_length=128)
    ma_runner = multi_agent.MultiAgentEnvRunner(
        target_match, lambda a: f"p_{a}", seed=0)
    ma_params = init(target_match.N_ACTIONS, target_match.N_ACTIONS, 17)
    ma_frag = ma_runner.sample({"p_a0": ma_params, "p_a1": ma_params},
                               mcfg.rollout_fragment_length)["p_a0"]

    def ma_case(frag, dev):
        p, s = fresh(ma_params, dev)
        batch = ppo.frags_to_batch([frag], ma_params, mcfg, dev)
        p, s, stats = ppo.ppo_update(
            p, s, batch, torch.Generator().manual_seed(0),
            num_epochs=mcfg.num_epochs,
            minibatch_size=min(mcfg.minibatch_size, batch["obs"].shape[0]),
            clip=mcfg.clip_param, ent_coeff=mcfg.entropy_coeff,
            vf_coeff=mcfg.vf_loss_coeff, grad_clip=mcfg.grad_clip,
            lr=mcfg.lr)
        return {"params": p, "mu": s["mu"], "nu": s["nu"],
                "stats": list(stats.values())}, {"params": s}

    cases["multi_agent_update"] = (ma_case, ma_frag)
    cases.update(offline_update_cases(cartpole, init, fresh, on))
    cases["dreamer_update"] = dreamer_update_case()
    return cases


# --------------------------------------------------------------------------
# Offline RL and DreamerV3 (phase 11 (d), (e)): the expert of
# tests/test_sac_marwil.py, a numpy ``iter_batches`` source for BC, and the
# DreamerV3 configuration of tests/test_dreamerv3.py's learning test.


def angle_policy(obs) -> int:
    """tests/test_sac_marwil.py's scripted CartPole expert: push toward the
    pole's fall direction."""
    angle, ang_vel = obs[2], obs[3]
    return 1 if angle + 0.5 * ang_vel > 0 else 0


class NumpyBatches:
    """An offline source for BC: ``iter_batches`` over numpy columns in
    order, the last batch partial, as a dataset's."""

    def __init__(self, columns):
        self.columns = columns

    def iter_batches(self, batch_size, batch_format="numpy"):
        n = len(next(iter(self.columns.values())))
        for i in range(0, n, batch_size):
            yield {k: v[i:i + batch_size] for k, v in self.columns.items()}


def bc_columns(marwil: bool):
    """tests/test_data_extras.py's rows: BC's expert (action 1 iff obs[0] >
    0), or MARWIL's mixed data (random actions, return = action)."""
    import numpy as np

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    if not marwil:
        return {"obs": obs, "actions": (obs[:, 0] > 0).astype(np.int64)}
    actions = rng.integers(0, 2, size=2000)
    return {"obs": obs, "actions": actions,
            "returns": actions.astype(np.float64)}


def dreamer_config(env):
    """tests/test_dreamerv3.py's learning configuration (deter 128, hidden
    128, B 8 x T 16, horizon 6, train ratio 48)."""
    from ray_tpu_torch.rllib.dreamerv3 import DreamerV3Config

    return DreamerV3Config(
        env=env, num_env_runners=1, rollout_fragment_length=68,
        batch_size=8, batch_length=16, train_ratio=48, deter=128,
        hidden=128, model_lr=3e-3, horizon=6, gamma=0.95,
        entropy_scale=0.03, seed=0)


def offline_update_cases(cartpole, init, fresh, on):
    """``rl_update_cases``' offline learners: ``_bc_update`` at beta 0 and
    3 on test_data_extras' rows, ``_marwil_update`` and ``_cql_update`` on
    a minibatch of their learners' transitions from expert episodes."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import bc, cql, marwil

    params = init(4, 2, 21)
    cases = {}

    def bc_case(beta):
        cfg = bc.MARWILConfig(beta=beta) if beta else bc.BCConfig()

        def run(cols, dev):
            p, s = fresh(params, dev)
            t = {k: torch.from_numpy(v[:256]).to(dev)
                 for k, v in cols.items()}
            p, s, loss = bc._bc_update(
                p, s, t["obs"], t["actions"], t["returns"], lr=cfg.lr,
                grad_clip=cfg.grad_clip, beta=beta, vf_coeff=cfg.vf_coeff)
            return {"params": p, "mu": s["mu"], "nu": s["nu"],
                    "loss": [loss]}, {"params": s}
        return run

    for beta in (0.0, 3.0):
        cols = bc_columns(marwil=bool(beta))
        cols["returns"] = cols.get(
            "returns", np.zeros(2000)).astype(np.float32)
        cases[f"bc_update_beta{beta:g}"] = (bc_case(beta), cols)

    episodes = marwil.collect_episodes(cartpole, angle_policy, 6, seed=3,
                                       max_steps=200)
    idx = np.random.default_rng(0).integers(0, sum(
        len(e["rewards"]) for e in episodes), 256)
    mcfg = marwil.MARWILConfig(env=cartpole, episodes=episodes)
    mdata = marwil.MARWIL(mcfg, "cpu")._data

    def marwil_case(batch, dev):
        p, s = fresh(params, dev)
        p, s, ws, *losses = marwil._marwil_update(
            p, s, torch.tensor(1.0, device=dev), on(batch, dev),
            beta=mcfg.beta, vf_coeff=mcfg.vf_coeff, lr=mcfg.lr,
            grad_clip=mcfg.grad_clip, max_weight=mcfg.max_weight)
        return {"params": p, "mu": s["mu"], "nu": s["nu"],
                "ws_and_losses": [ws, *losses]}, {"params": s}

    cases["marwil_update"] = (marwil_case,
                              {k: v[idx] for k, v in mdata.items()})

    ccfg = cql.CQLConfig(env=cartpole, episodes=episodes)
    cdata = cql.CQL(ccfg, "cpu")._data
    target = init(4, 2, 22)

    def cql_case(batch, dev):
        p, s = fresh(params, dev)
        p, s, *losses = cql._cql_update(
            p, on(target, dev), s, on(batch, dev), gamma=ccfg.gamma,
            lr=ccfg.lr, grad_clip=ccfg.grad_clip, cql_alpha=ccfg.cql_alpha)
        return {"params": p, "mu": s["mu"], "nu": s["nu"],
                "losses": losses}, {"params": s}

    cases["cql_update"] = (cql_case, {k: v[idx] for k, v in cdata.items()})
    return cases


class ReplayDraws:
    """A Gumbel source handing out recorded CPU draws in order, each moved
    to ``device``; records the smallest top-two gap of the scores each
    draw decides (through ``dreamerv3.categorical``, wrapped while the
    source is in use)."""

    def __init__(self, draws, device):
        self.draws, self.device, self.gaps = list(draws), device, []

    def __call__(self, shape):
        draw = self.draws.pop(0)
        assert tuple(draw.shape) == tuple(shape), (draw.shape, shape)
        return draw.to(self.device)

    def __enter__(self):
        import torch

        from ray_tpu_torch.rllib import dreamerv3

        self._real = real = dreamerv3.categorical

        def recording(logits, gumbel):
            g = gumbel(tuple(logits.shape))
            top2 = torch.topk((g + logits).detach(), 2, dim=-1).values
            self.gaps.append(top2[..., 0] - top2[..., 1])
            return real(logits, lambda shape: g)

        dreamerv3.categorical = recording
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.rllib import dreamerv3

        dreamerv3.categorical = self._real

    def min_gap(self) -> float:
        return min(float(g.min()) for g in self.gaps)


def dreamer_update_case():
    """``rl_update_cases``' DreamerV3 update at the learning test's
    configuration: a batch replayed from a runner's fragments on
    OneHotBanditEnv, the same Gumbel draws injected on both devices."""
    import torch

    from ray_tpu_torch.rllib import dreamerv3, module
    from ray_tpu_torch.rllib.examples import OneHotBanditEnv

    cfg = dreamer_config(OneHotBanditEnv)
    params = dreamerv3.init_params(cfg, 4, 4, torch.Generator()
                                   .manual_seed(31), "cpu")
    runner = dreamerv3.DreamerEnvRunner(cfg, seed=0)
    buf = dreamerv3.SequenceReplay(cfg.buffer_size_steps, seed=0)
    for _ in range(2):
        buf.add(runner.sample(module.host_copy(params),
                              cfg.rollout_fragment_length))
    batch = buf.sample(cfg.batch_size, cfg.batch_length)
    B, T, V, C = (cfg.batch_size, cfg.batch_length, cfg.stoch_vars,
                  cfg.stoch_classes)
    shapes = [(B, V, C)] * T + [(B * T, 4), (B * T, V, C)] * cfg.horizon
    gumbel = dreamerv3.GumbelDraws(torch.Generator().manual_seed(32))
    draws = [gumbel(s) for s in shapes]

    def run(inputs, dev):
        batch, draws = inputs
        p = module.tree_to(params, dev, copy=True)
        txs = dreamerv3._optimizers(cfg)
        opts = {"model": txs["model"].init(p),
                "actor": txs["actor"].init(p["actor"]),
                "critic": txs["critic"].init(p["critic"])}
        target = module.tree_to(p["critic"], dev, copy=True)
        with ReplayDraws(draws, dev) as replay:
            p, target, opts, retnorm, m = dreamerv3._update(
                cfg, p, target, opts, torch.tensor(1.0, device=dev),
                {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                replay)
        assert not replay.draws
        run.min_gap = min(replay.min_gap(), getattr(run, "min_gap",
                                                    math.inf))
        heads = ("actor", "critic")
        model = {k: v for k, v in p.items() if k not in heads}

        def wm(tree):
            return {k: v for k, v in tree.items() if k not in heads}

        trees = {"world_model": model, "actor": p["actor"],
                 "critic": p["critic"], "critic_target": target,
                 "retnorm_and_metrics": [retnorm, *m.values()]}
        adam = {"world_model": {"count": opts["model"]["count"],
                                "nu": wm(opts["model"]["nu"])},
                "actor": opts["actor"], "critic": opts["critic"]}
        for name, s in opts.items():
            trees[f"{name}_mu"], trees[f"{name}_nu"] = s["mu"], s["nu"]
        return trees, adam

    return run, (batch, draws)


def rl_update_agreement(report, device):
    """Phase 11 (a): each learner update on ``device`` against the same
    update on the CPU, from the same parameters and recorded batch."""
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.examples import TargetMatchEnv

    rows, bad = {}, []
    for name, (fn, inputs) in rl_update_cases(
            EnvRunner, NumpyCartPole, TargetMatchEnv).items():
        want, adam = fn(inputs, "cpu")
        got, _ = fn(inputs, device)
        # parameters carry Adam's near-eps entries; moments, losses and TD
        # errors are held to the ordinary tolerance
        errs = {key: rl_state_err(got[key], want[key], adam.get(key))
                for key in want}
        worst = max(e[0] for e in errs.values())
        soft = max(e[1] for e in errs.values())
        share = max(e[2] for e in errs.values())
        rows[name] = {"max_abs_err": worst, "ill_conditioned_err": soft,
                      "ill_conditioned_share": share,
                      "by_output": {k: e[0] for k, e in errs.items()}}
        # DreamerV3's draws: the smallest top-two score gap of any argmax
        # over its injected Gumbel noise, far above the errors, or a
        # flipped draw could explain a disagreement
        gap = getattr(fn, "min_gap", None)
        if gap is not None:
            rows[name]["min_top2_gap"] = gap
        print(f"rllib {name} on {device} against the CPU: max abs err "
              f"{worst:.3e} (tol {RL_UPDATE_TOL:.0e}); near-eps Adam "
              f"entries {share:.4f} of them, err {soft:.3e} (tol "
              f"{RL_ADAM_TOL:.0e})"
              + ("" if gap is None else f"; smallest top-two gap of a "
                 f"draw {gap:.3e}"), flush=True)
        if not (worst <= RL_UPDATE_TOL and soft <= RL_ADAM_TOL):
            bad.append(name)
    report["rllib"]["update_agreement"] = rows
    if bad:
        raise SystemExit(f"learner updates on {device} disagree with the "
                         f"CPU: {bad}")


def rl_learn(name, algo, iters, stop_at=None):
    """Train ``algo`` for ``iters`` iterations (fewer once the best return
    reaches ``stop_at``); returns (best return, last result, a row of
    timings).  An update is one call of the algorithm's update function:
    ``learn_time_ms`` of an iteration over its updates."""
    best, result, per_update = -math.inf, None, []
    t0, n_iters = time.perf_counter(), 0
    try:
        for _ in range(iters):
            result = algo.train()
            n_iters += 1
            ret = result["episode_return_mean"]
            if ret is not None and math.isfinite(ret):
                best = max(best, ret)
            n_up = result.get("num_updates", 1)  # PPO and APPO: one
            if n_up:
                per_update.append(result["learn_time_ms"] / n_up)
            if stop_at is not None and best >= stop_at:
                break
    finally:
        algo.stop()
    wall = time.perf_counter() - t0
    steps = result.get("timesteps_total", result.get("env_steps_sampled"))
    per_update.sort()
    row = {"iterations": n_iters, "best_return": best,
           "env_steps": steps, "wall_s": wall,
           "env_steps_per_s": steps / wall,
           "update_ms_p50": (per_update[len(per_update) // 2]
                             if per_update else None),
           "iterations_timed": len(per_update)}
    print(f"rllib {name}: best return {best:.2f} in {n_iters} iterations, "
          f"{steps} env steps at {row['env_steps_per_s']:.1f}/s, update ms "
          f"p50 {fmt_ms(row['update_ms_p50'])} over {len(per_update)} "
          f"iterations, {wall:.2f} s", flush=True)
    return best, result, row


def run_rllib(report):
    """Phase 11: online RLlib with the learners on the card and the env
    runners' forward on the CPU."""
    import torch

    from ray_tpu_torch.rllib import module, ppo
    from ray_tpu_torch.rllib.appo import APPOConfig
    from ray_tpu_torch.rllib.dqn import DQNConfig
    from ray_tpu_torch.rllib.examples import TargetMatchEnv
    from ray_tpu_torch.rllib.impala import IMPALAConfig
    from ray_tpu_torch.rllib.multi_agent import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.sac import SACConfig
    from ray_tpu_torch.train.step import tree_leaves

    t_phase = time.monotonic()
    report["rllib"] = {}
    rl_update_agreement(report, "cuda")

    # (b) PPO at tests/test_rllib.py's configuration; the runners' forward
    # devices are read through a wrapper of action_dist
    forward_devices = set()
    action_dist = module.action_dist

    def recorded(params, obs, generator):
        forward_devices.update({obs.device.type, generator.device.type,
                                *(t.device.type for t in
                                  tree_leaves(params))})
        return action_dist(params, obs, generator)

    module.action_dist = recorded
    try:
        algo = ppo.PPOConfig().environment(NumpyCartPole).env_runners(
            num_env_runners=2, num_envs_per_env_runner=4,
            rollout_fragment_length=128,
        ).training(lr=3e-3, num_epochs=6, minibatch_size=256,
                   entropy_coeff=0.01, seed=3).build()
        learner_devices = {t.device.type for t in tree_leaves(algo.params)}
        first, iters = None, []
        t0 = time.perf_counter()
        for _ in range(12):
            result = algo.train()
            if first is None and result["num_episodes"] > 0:
                first = result["episode_return_mean"]
            n = 2 * 4 * 128
            it = {"return": result["episode_return_mean"],
                  "sample_s": result["sample_time_s"],
                  "update_ms": result["learn_time_ms"],
                  "env_steps_per_s": n / result["time_this_iter_s"]}
            iters.append(it)
            print(f"rllib ppo iteration {result['training_iteration']}: "
                  f"return {it['return']:.2f}, sample {it['sample_s']:.4f} "
                  f"s, update {it['update_ms']:.2f} ms, "
                  f"{it['env_steps_per_s']:.1f} env steps/s", flush=True)
        ppo_wall = time.perf_counter() - t0
    finally:
        module.action_dist = action_dist
    learner_devices |= {t.device.type for t in tree_leaves(algo.params)}
    last = result["episode_return_mean"]
    ok_ppo = (result["training_iteration"] == 12
              and result["timesteps_total"] == 12 * 2 * 4 * 128
              and last > max(60.0, (first or 0) * 1.5))
    print(f"rllib ppo (tests/test_rllib.py's configuration, NumpyCartPole):"
          f" first {first}, last {last:.2f}, gate > "
          f"{max(60.0, (first or 0) * 1.5):.2f}; {result['timesteps_total']}"
          f" env steps in {ppo_wall:.2f} s; learner on {learner_devices}, "
          f"runners' forward on {forward_devices}", flush=True)

    # one ppo_update under the profiler, on copies of the learner's state
    # and a fresh batch, with no sampling in flight
    frags, behavior = algo._collect()
    algo.stop()
    batch = ppo.frags_to_batch(frags, behavior, algo.config, "cuda")
    cfg = algo.config

    p = module.tree_to(algo.params, "cuda", copy=True)
    s = module.tree_to(algo.opt_state, "cuda", copy=True)

    def update():
        _, _, stats = ppo.ppo_update(
            p, s, batch, torch.Generator().manual_seed(0),
            num_epochs=cfg.num_epochs, minibatch_size=cfg.minibatch_size,
            clip=cfg.clip_param, ent_coeff=cfg.entropy_coeff,
            vf_coeff=cfg.vf_loss_coeff, grad_clip=cfg.grad_clip, lr=cfg.lr)
        return stats

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    update_ms = sorted(walls)[1]
    rows = device_events(update)
    busy = sum(r[1] for r in rows) if rows else None
    launches = sum(r[2] for r in rows) if rows else None
    idle = None if busy is None else 1 - busy / update_ms
    print(f"rllib ppo_update ({cfg.num_epochs} epochs x "
          f"{batch['obs'].shape[0] // cfg.minibatch_size} minibatches of "
          f"{cfg.minibatch_size}): {update_ms:.3f} ms (median of 3, host "
          f"clock), device busy {fmt_ms(busy)} ms, idle share "
          + ("not measured" if idle is None else f"{idle:.4f}")
          + f", {launches} kernel launches; top: " + "; ".join(
              f"{k[:48]} {t:.3f} ms x{c}" for k, t, c in rows[:6]),
          flush=True)
    report["rllib"]["ppo"] = {
        "first_return": first, "last_return": last,
        "timesteps_total": result["timesteps_total"], "wall_s": ppo_wall,
        "iterations": iters, "learner_devices": sorted(learner_devices),
        "runner_forward_devices": sorted(forward_devices),
        "profiled_update": {
            "update_ms": update_ms, "update_ms_readings": walls,
            "device_busy_ms": busy, "idle_share": idle,
            "kernel_launches": launches,
            "top": [{"op": k[:90], "ms": t, "count": c}
                    for k, t, c in rows[:12]]}}
    if not ok_ppo:
        raise SystemExit("PPO did not pass tests/test_rllib.py's gate")
    if learner_devices != {"cuda"} or forward_devices != {"cpu"}:
        raise SystemExit(f"learner on {learner_devices}, runners' forward "
                         f"on {forward_devices}: want cuda and cpu")

    # (c) the other algorithms at their JAX tests' configurations and gates
    gates = {}
    algo = APPOConfig(num_env_runners=2, num_envs_per_runner=2,
                      rollout_fragment_length=64, lr=5e-3,
                      minibatch_size=128, seed=0, env=NumpyCartPole).build()
    inflight = []
    train = algo.train

    def appo_train():
        out = train()
        inflight.append(algo._inflight is not None)
        return out

    algo.train = appo_train
    best, _, row = rl_learn("appo", algo, 30, stop_at=60.0)
    gates["appo"] = (best >= 60.0 and all(inflight), row)

    algo = IMPALAConfig(num_env_runners=2, num_envs_per_runner=4,
                        rollout_fragment_length=64, lr=7e-4,
                        entropy_coeff=0.02, seed=1,
                        env=NumpyCartPole).build()
    best, result, row = rl_learn("impala", algo, 30)
    row["mean_rho"] = result.get("mean_rho")
    gates["impala"] = (best > 60 and result["loss"] is not None
                       and result["mean_rho"] > 0, row)

    algo = DQNConfig(num_env_runners=2, num_envs_per_runner=2,
                     rollout_fragment_length=64, learning_starts=256,
                     train_batch_size=64, num_updates_per_iter=8,
                     target_network_update_freq=300,
                     epsilon_decay_steps=2500, seed=3,
                     env=NumpyCartPole).build()
    best, result, row = rl_learn("dqn", algo, 22)
    gates["dqn"] = (best > 60 and result["num_updates"] > 0
                    and result["loss"] is not None, row)

    algo = SACConfig(num_env_runners=2, num_envs_per_runner=2,
                     rollout_fragment_length=64, learning_starts=256,
                     train_batch_size=128, num_updates_per_iter=24, seed=0,
                     env=NumpyCartPole).build()
    best, result, row = rl_learn("sac", algo, 45, stop_at=50.0)
    row["alpha"] = result["alpha"]
    gates["sac"] = (best >= 50.0 and result["alpha"] > 0.0, row)

    algo = MultiAgentPPOConfig(
        env=TargetMatchEnv, policy_mapping_fn=lambda a: f"p_{a}",
        num_env_runners=1, rollout_fragment_length=128, seed=0, lr=5e-3,
        num_epochs=6).build()
    best, result, row = rl_learn("multi_agent_ppo", algo, 15, stop_at=24.0)
    row["per_agent_return_mean"] = result["per_agent_return_mean"]
    gates["multi_agent_ppo"] = (
        best >= 24.0 and set(result["policies"]) == {"p_a0", "p_a1"}
        and min(result["per_agent_return_mean"].values()) >= 9.0, row)

    rl_offline(report, gates)
    rl_dreamer(report, gates)

    report["rllib"]["algorithms"] = {k: row for k, (_, row) in gates.items()}
    report["rllib"]["phase_s"] = time.monotonic() - t_phase
    print(f"rllib phase: {report['rllib']['phase_s']:.1f} s", flush=True)
    failed = [k for k, (ok, _) in gates.items() if not ok]
    if failed:
        raise SystemExit(f"RL learning gates failed: {failed}")


def rl_offline(report, gates):
    """Phase 11 (d): MARWIL (beta 1 and 0) and CQL from expert episodes
    of NumpyCartPole, and BC and BC-MARWIL over a numpy ``iter_batches``
    source, at the JAX tests' configurations and gates
    (tests/test_sac_marwil.py, tests/test_data_extras.py:51-96); the
    learners on the card, the evaluation rollouts' forward on the CPU."""
    import numpy as np

    from ray_tpu_torch.rllib import bc, cql, marwil, module
    from ray_tpu_torch.train.step import tree_leaves

    t_phase = time.perf_counter()
    eval_devices = set()
    greedy = module.greedy_action

    def recorded(params, obs):
        eval_devices.update({obs.device.type,
                             *(t.device.type for t in tree_leaves(params))})
        return greedy(params, obs)

    def learn(algo, iters, per_iter):
        """(the results, a row of timings and the learner's devices) of
        ``iters`` iterations of ``per_iter`` updates each."""
        devices = {t.device.type for t in tree_leaves(algo.params)}
        results, ms = [], []
        t0 = time.perf_counter()
        for _ in range(iters):
            results.append(algo.train())
            ms.append(results[-1]["time_this_iter_s"] * 1e3 / per_iter)
        ms.sort()
        row = {"iterations": iters, "updates": iters * per_iter,
               "update_ms_p50": ms[len(ms) // 2],
               "train_s": time.perf_counter() - t0,
               "learner_devices": sorted(devices)}
        return results, row

    def evaluate(algo, n):
        module.greedy_action = recorded
        try:
            return algo.evaluate(n_episodes=n)
        finally:
            module.greedy_action = greedy

    def show(name, row, gate):
        print(f"rllib {name}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items()) + f"; gate {gate}", flush=True)

    for name, n_eps, seed, beta, iters, n_eval, floor in (
            ("marwil", 30, 7, 1.0, 12, 5, 80.0),
            ("marwil_beta0", 20, 11, 0.0, 8, 3, 60.0)):
        eps = marwil.collect_episodes(NumpyCartPole, angle_policy, n_eps,
                                      seed=seed, max_steps=300)
        behavior = float(np.mean([e["rewards"].sum() for e in eps]))
        algo = marwil.MARWILConfig(env=NumpyCartPole, episodes=eps,
                                   beta=beta, seed=0,
                                   num_updates_per_iter=64).build()
        results, row = learn(algo, iters, 64)
        row.update(behavior_return=behavior,
                   loss_last=results[-1]["loss"],
                   eval_return=evaluate(algo, n_eval))
        gate = f"eval >= {floor:g} over {n_eval} episodes"
        show(name, row, gate)
        gates[name] = (row["eval_return"] >= floor
                       and (beta == 0.0 or behavior > 100), row)

    eps = marwil.collect_episodes(NumpyCartPole, angle_policy, 30, seed=5,
                                  max_steps=300)
    algo = cql.CQLConfig(env=NumpyCartPole, episodes=eps, cql_alpha=1.0,
                         seed=0, num_updates_per_iter=64).build()
    results, row = learn(algo, 12, 64)
    row.update(cql_gap_first=results[0]["cql_gap"],
               cql_gap_last=results[-1]["cql_gap"],
               eval_return=evaluate(algo, 4))
    show("cql", row, "the gap falls, eval >= 80 over 4 episodes")
    gates["cql"] = (row["cql_gap_last"] < row["cql_gap_first"]
                    and row["eval_return"] >= 80.0, row)

    cols = bc_columns(marwil=False)
    algo = bc.BCConfig(obs_dim=4, n_actions=2,
                       input_dataset=NumpyBatches(cols),
                       train_batch_size=256, lr=3e-3, seed=0).build()
    results, row = learn(algo, 5, 8)  # 8 batches an iteration
    matches = sum(algo.compute_single_action(o) == int(o[0] > 0)
                  for o in cols["obs"][:200])
    row.update(loss_first=results[0]["loss"], loss_last=results[-1]["loss"],
               expert_matches=matches)
    show("bc", row, "the loss falls, >= 180 of 200 rows match the expert")
    gates["bc"] = (row["loss_last"] < row["loss_first"] and matches >= 180,
                   row)

    cols = bc_columns(marwil=True)
    algo = bc.MARWILConfig(obs_dim=4, n_actions=2,
                           input_dataset=NumpyBatches(cols), beta=3.0,
                           lr=3e-3, seed=0).build()
    results, row = learn(algo, 5, 8)
    row["share_of_action_1"] = float(np.mean(
        [algo.compute_single_action(o) for o in cols["obs"][:200]]))
    show("bc_marwil", row, "share of action 1 > 0.8")
    gates["bc_marwil"] = (row["share_of_action_1"] > 0.8, row)
    report["rllib"]["offline_phase_s"] = time.perf_counter() - t_phase
    print(f"rllib offline phase: {report['rllib']['offline_phase_s']:.2f} "
          f"s; evaluation rollouts' forward on {sorted(eval_devices)}",
          flush=True)
    if eval_devices != {"cpu"}:
        raise SystemExit(f"offline evaluation forward on {eval_devices}: "
                         "want the CPU (a host copy)")


def rl_dreamer(report, gates):
    """Phase 11 (e): DreamerV3 at tests/test_dreamerv3.py's learning
    configuration and gate on OneHotBanditEnv (best return >= 10 within
    80 iterations, the world-model loss falling), the learner on the card
    and the runner's filtering state and forward on the CPU; then one
    ``_update`` under the profiler on copies of the learner's state."""
    import torch

    from ray_tpu_torch.rllib import dreamerv3, module
    from ray_tpu_torch.rllib.examples import OneHotBanditEnv
    from ray_tpu_torch.train.step import tree_leaves

    runner_devices = set()
    sample = dreamerv3.DreamerEnvRunner.sample

    def recorded(self, params, num_steps):
        out = sample(self, params, num_steps)
        runner_devices.update({self._h.device.type, self._z.device.type,
                               *(t.device.type
                                 for t in tree_leaves(params))})
        return out

    t0 = time.perf_counter()
    algo = dreamer_config(OneHotBanditEnv).build()
    dreamerv3.DreamerEnvRunner.sample = recorded
    try:
        learner_devices = {t.device.type for t in
                           tree_leaves([algo.params, algo.critic_target,
                                        algo.opts["model"]["mu"],
                                        algo.retnorm])}
        best, wm, per_update, iters = -math.inf, [], [], 0
        for _ in range(80):
            result = algo.train()
            iters += 1
            if result.get("wm_loss") is not None:
                wm.append(result["wm_loss"])
            if result["episode_return_mean"] is not None:
                best = max(best, result["episode_return_mean"])
            if result["updates_this_iter"]:
                per_update.append(result["learn_time_ms"]
                                  / result["updates_this_iter"])
            if best >= 10.0:
                break
        learn_s = time.perf_counter() - t0
        profiled = dreamer_profile(algo)
    finally:
        dreamerv3.DreamerEnvRunner.sample = sample
        algo.stop()
    per_update.sort()
    row = {"iterations": iters, "updates": result["num_updates"],
           "best_return": best, "wm_loss_first": wm[0] if wm else None,
           "wm_loss_last": wm[-1] if wm else None,
           "update_ms_p50": per_update[len(per_update) // 2],
           "env_steps": result["env_steps_sampled"], "learn_s": learn_s,
           "phase_s": time.perf_counter() - t0,
           "learner_devices": sorted(learner_devices),
           "runner_devices": sorted(runner_devices),
           "profiled_update": profiled}
    print(f"rllib dreamerv3 (tests/test_dreamerv3.py's configuration, "
          f"OneHotBanditEnv): best return {best:.2f} in {iters} iterations "
          f"(gate >= 10 within 80), {row['updates']} updates, update ms p50 "
          f"{row['update_ms_p50']:.2f}, world-model loss "
          f"{row['wm_loss_first']} -> {row['wm_loss_last']}, "
          f"{row['env_steps']} env steps; learning {learn_s:.2f} s, phase "
          f"{row['phase_s']:.2f} s; learner on {sorted(learner_devices)}, "
          f"runner's state and forward on {sorted(runner_devices)}",
          flush=True)
    gates["dreamerv3"] = (best >= 10.0 and bool(wm) and wm[-1] < wm[0], row)
    if learner_devices != {"cuda"} or runner_devices != {"cpu"}:
        raise SystemExit(f"DreamerV3 learner on {learner_devices}, runner "
                         f"on {runner_devices}: want cuda and cpu")


def dispatched_ops(fn):
    """(aten operations ``fn`` dispatches that are not views, {name:
    count}): the operations that can launch a device kernel, counted
    below autograd (backward included) on any device.  Allocations
    (``empty``) and copies count too."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    counts = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                counts[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return sum(counts.values()), dict(counts.most_common())


def dreamer_profile(algo):
    """One DreamerV3 ``_update`` at ``algo``'s configuration on copies of
    its state and a batch from its buffer: host ms (median of 3, the card
    synchronised), device-busy ms, idle share, device operations and the
    top device operations (``device_events``: whole windows only)."""
    import torch

    from ray_tpu_torch.rllib import dreamerv3, module

    cfg = algo.config
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             algo.buffer.sample(cfg.batch_size, cfg.batch_length).items()}
    p, target, opts = (module.tree_to(t, "cuda", copy=True) for t in
                       (algo.params, algo.critic_target, algo.opts))
    gumbel = dreamerv3.GumbelDraws(torch.Generator("cuda").manual_seed(0))

    def update():
        return dreamerv3._update(cfg, p, target, opts, algo.retnorm.clone(),
                                 batch, gumbel)[4]

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    update_ms = sorted(walls)[1]
    n_ops, by_op = dispatched_ops(update)
    rows = device_events(update)
    busy = sum(r[1] for r in rows) if rows else None
    launches = sum(r[2] for r in rows) if rows else None
    idle = None if busy is None else 1 - busy / update_ms
    print(f"rllib dreamerv3 _update (B {cfg.batch_size} x T "
          f"{cfg.batch_length}, horizon {cfg.horizon}, deter {cfg.deter}): "
          f"{update_ms:.3f} ms (median of 3, host clock), device busy "
          f"{fmt_ms(busy)} ms, idle share "
          + ("not measured" if idle is None else f"{idle:.4f}")
          + f", {launches} device operations ({n_ops} aten operations "
          f"dispatched, not views); top: " + "; ".join(
              f"{k[:48]} {t:.3f} ms x{c}" for k, t, c in rows[:6]),
          flush=True)
    return {"update_ms": update_ms, "update_ms_readings": walls,
            "device_busy_ms": busy, "idle_share": idle,
            "device_operations": launches, "aten_operations": n_ops,
            "aten_operations_by_name": by_op,
            "top": [{"op": k[:90], "ms": t, "count": c}
                    for k, t, c in rows[:12]]}


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
    paths = _build.build(["flash_fwd", "flash_bwd"])
    report["build_s"] = time.monotonic() - t0
    print(f"built {sorted(paths)} in {report['build_s']:.1f} s", flush=True)
    for name, path in paths.items():
        log = path.with_name(path.name + ".log")
        info = ptxas_report(log.read_text()) if log.exists() else {}
        report[f"ptxas_{name}"] = info
        # the tensor-core kernels' shared memory is dynamic, which ptxas
        # does not see (the .cu files state its size)
        for kernel, line in info.items():
            if "mma" in kernel:
                print(f"ptxas {kernel}: {line}", flush=True)

    check_kernels(report)
    check_backward(report)
    time_kernels(report)
    first = time_attention(report, 1)
    check_apply(report)
    engine_launches = run_engine(report)
    frontend_launches = run_frontends(report)
    serve_launches = run_serve_bench(report)
    trainer_launches = run_trainer(report)
    torch_trainer_launches = run_torch_trainer(report)
    mixtral = [time_attention(report, 1, MIXTRAL_SHAPE)]
    moe_launches = run_moe_trainer(report)
    mixtral.append(time_attention(report, 2, MIXTRAL_SHAPE))
    llama3 = [time_attention(report, 1, LLAMA3_SHAPE, LLAMA3_PLAIN)]
    llama3_launches = run_llama3_trainer(report)
    llama3.append(time_attention(report, 2, LLAMA3_SHAPE, LLAMA3_PLAIN))
    second = time_attention(report, 2)
    run_rllib(report)

    # times at the trainer's shape, and at the MoE trainer's under
    # at_mixtral_shape; launches are the counted runs of every path
    sources = {"flash_fwd": ("flash_fwd.cu", "ray_tpu/ops/attention.py:121"),
               "flash_bwd_dkv": ("flash_bwd.cu",
                                 "ray_tpu/ops/attention.py:280"),
               "flash_bwd_dq": ("flash_bwd.cu",
                                "ray_tpu/ops/attention.py:303")}
    kernels = []
    for name, (src, replaces) in sources.items():
        row = first[name]
        by_path = {"trainer": trainer_launches[name],
                   "torch_trainer": torch_trainer_launches[name],
                   "moe_trainer": moe_launches[name],
                   "llama3_trainer": llama3_launches[name]}
        if name == "flash_fwd":
            by_path = {"engine": engine_launches,
                       "frontends": frontend_launches,
                       "serve_bench": serve_launches, **by_path}
        entry = {"name": name, "route": "cuda",
                 "source": f"ray_tpu_torch/ops/csrc/{src}",
                 "replaces": replaces,
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "timed_by": row["timed_by"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"],
                 "design": DESIGN[name],
                 "ms_readings": [row["ms"], second[name]["ms"]],
                 "library_ms_readings": [row["library_ms"],
                                         second[name]["library_ms"]],
                 "at_mixtral_shape": {
                     key: mixtral[0][name][key]
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "max_abs_err")}}
        entry["at_mixtral_shape"].update(
            ms_readings=[r[name]["ms"] for r in mixtral],
            library_ms_readings=[r[name]["library_ms"] for r in mixtral])
        entry["at_llama3_shape"] = {
            key: llama3[0][name][key]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err", "plain_shape")}
        entry["at_llama3_shape"].update(
            ms_readings=[r[name]["ms"] for r in llama3],
            library_ms_readings=[r[name]["library_ms"] for r in llama3])
        if name == "flash_fwd":
            # the JAX serving paths run XLA einsum attention, no Pallas call
            entry["replaces_on_serving_paths"] = "ray_tpu/llm/model.py:41-85"
        kernels.append(entry)
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
