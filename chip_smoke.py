#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  0. the port's static checker (``run_check``) in a child process on the
     card's host, before any card work: ``rtpu check --json`` over the
     checkout, clean, all six passes, neither torch nor JAX imported; its
     counts and the child's wall and CPU time printed;
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
  6. the port's runtime on the card (``run_runtime``): the node counts
     the card as ``"GPU": 1`` (the session root and the native lanes
     printed); a 64 MB bf16 CUDA tensor ``put`` from the driver (one copy
     from the device into the store slot) and read in a ``num_gpus=1``
     task, moved onto the card and checksummed there, its bytes equal (put
     and get-plus-H2D GB/s, two readings each; the same D2H outside the
     store into fresh and warm pageable memory and into pinned memory; a
     small CPU tensor's round trip p50 / p90); the serving engine in an actor holding the card
     (``num_gpus=1``, built like phase 5's from the same seed) answering
     phase 5's 3 unloaded requests with the same greedy ids, bit for bit,
     and its 19-request mix by concurrent actor calls, every request full,
     the forward kernel launched in the actor's process (its tok/s against
     phase 5's, a no-op call's and a request's call overhead); the actor's
     device-memory gauges read from the scheduler's ``metrics_snapshot``
     after its flusher's push, equal to its own ``memory_stats()``, and
     its kernel-build counters; a 64 MB bf16 device object
     (``tensor_transport="device"``) relayed to a consumer in another
     process with equal bytes and one relay pull (relay GB/s), the same
     object got in the producer's own process as the resident tensor (same
     ``data_ptr``, no store write, no relay pull), and
     ``free_device_object`` releasing its 64 MB on the card, a later get
     raising "no longer resident";
  7. the serving front ends at the serving width (``run_frontends``): the
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
  8. routed serving at the serving width (``run_serve_bench``): two
     engines behind the pow-2 and prefix-aware routers under
     ``_private/serve_bench.py``'s load-wall ladder (4:128 and 32:512:
     the reference's top rung cut to half its requests, its middle rung
     left out for time), then its
     kill rung with the KV tier off and on: every request of every cell
     completes without an error, the top rung evicts pages under both
     policies, prefix-aware saves prefill tokens, copies COW pages and
     hits more than pow-2, the tier-on kill cell pulls, and the forward
     kernel launches once a layer for every prefill through
     ``lm.prefill``; each rung's req/s, TTFT, evictions
     and hit rate, the reference's acceptance as computed here, and the
     device-busy share of a profiled rerun of a quarter of the top
     prefix-aware cell;
 8b. the serve runtime on the card (``run_serve``): the port's runtime
     with the card as ``"GPU": 1``; (a) ``build_openai_app`` at the
     serving width with two ``LLMServer`` replicas at ``num_gpus`` 0.5,
     each its own process holding the card (device-memory gauge over its
     weights' bytes, 0 kernel builds), the controller and the HTTP proxy
     without CUDA, ``run_engine``'s 3 unloaded requests giving its ids bit
     for bit on each replica; (b) ``run_engine``'s 19-request mix through
     the HTTP proxy, whole and as SSE streams: every request full, both
     replicas serving, the forward kernel launched in each replica's
     process (read there), its output tok/s beside ``run_engine``'s and
     ``run_frontends``' server rate, TTFT p50 / p90, each replica's share
     and device-busy share; (c) ``serve_bench``'s kill-rung traffic, 48
     requests at concurrency 8 through the ingress, the replica holding the
     most families killed after 45%: every request completes, the
     controller reports the death and a replacement holds the card, the
     killed process exits, and the store tier pulls (recovery s, extra
     prefill tokens); (d) ``build_pd_openai_app``, one prefill and one
     decode replica: the handoff through the store tier between the two
     processes, the decode replica pulling, ids equal to a single engine's
     pulling the same spines (prefill and decode call ms, the pull's ms);
  9. the trainer at full width (``bench.py``'s GPT-2 124M train step, batch
     12, seq 1024): the first step's loss and grad norm through the kernels
     agree with the plain attention's, the loss falls on a repeated batch,
     each of the three wrappers launches 12 times a step, and a few steps
     are timed and profiled; the profiled step shows 12 launches of each
     tensor-core kernel (``BF16_KERNELS``) and none of the scalar ones
     (``SCALAR_KERNELS``): the bf16 path runs no scalar kernel;
 10. the user's train loop (``run_torch_trainer``): ``TorchTrainer`` with
     one NCCL GPU worker, an actor of the port's runtime in a ``{"CPU": 1,
     "GPU": 1}`` placement-group bundle, over ``from_numpy`` int32 token
     rows dealt by ``streaming_split``'s coordinator actor, read by
     ``get_dataset_shard("train").iter_torch_batches`` onto the card
     (pinned staging, a side stream, two batches in flight) into phase
     9's GPT-2 124M step, 3 warm-up and 24 timed steps, the group formed
     at ``TorchConfig``'s default address (the rank's ``MASTER_ADDR`` and
     ``MASTER_PORT`` printed): the loss finite
     and falling, the rows consumed equal to the source's (sha256), the
     worker's first loss equal to this process's own step on the same
     parameters and rows, 12 launches of each kernel a step in the
     worker; its tokens/s against phase 9's, the ``next(batch)`` wait
     p50 / p90, the share of copies done before the step on the batch
     before them ended, and one batch's and a 64 MB block's H2D GB/s,
     pinned and pageable;
 10b. Tune on the card (``run_tune``), each trial an actor of the port's
     runtime training phase 9's GPT-2 124M step in its own process on
     rows of ids below 512: (a) ASHA (max_t 24, grace 6, factor 2) over 4
     learning rates, two trials at a time at ``num_gpus`` 0.5 each: all
     end, one at least stops at a rung, every first loss equals this
     process's step on the same parameters and rows, 1e-6 ranks last, the
     best trial's loss falls, 12 launches of each kernel a step in each
     trial's process on ``cuda:0`` under its grant; start-up seconds and
     the concurrent pair's tokens/s against phase 9's; (b) ``TorchTrainer``
     inside a trial with no GPU, its worker in a ``{"CPU": 1, "GPU": 1}``
     bundle, ``callbacks`` feeding ``tune.report``, a checkpoint every 4
     of 12 steps and the worker's process exiting at step 6 once: the
     second attempt from the step-4 checkpoint with the same loss there,
     the killed process gone, no CUDA context in the trial's process;
     seconds to a new worker, checkpoint GB/s, steps lost; (c) PBT over 2
     trials at 2 layers, 12 steps: the weak trial exploits and its first
     loss after the restore equals the donor's at that step;
 10c. the actor plane on the card (``run_actor_plane``): two actors at
     ``num_gpus`` 0.5, each holding phase 9's GPT-2 124M from one seed:
     (a) a compiled DAG of two pipeline stages (blocks 0-5; blocks 6-11,
     the final norm and the head), 8 microbatches of 12 x 1024 tokens
     submitted before any is read: each row's loss equal to this
     process's whole forward within phase 9's tolerance, the argmax ids
     equal, 6 forward launches a microbatch in each stage's process, an
     error raised in stage 1 returned at its ref's get with later refs
     answered, and teardown unlinking the rings with both actors alive;
     microbatches/s and tokens/s against this process's forward, the
     18.9 MB handoff's path and GB/s; (b) the same actors as two
     data-parallel ranks of a declared collective group, 6 rows each,
     their f32 gradients summed by ``allreduce`` and halved before the
     trainer's AdamW step, 3 steps: the ranks' parameters equal to the
     bit after every step, each step's loss equal to this process's
     full-batch step, 12 / 12 / 12 launches a step on each rank; the
     allreduce's seconds and GB/s;
 10d. the data plane on the card (``run_data``), ``Dataset`` a lazy plan
     run by the streaming executor on the port's runtime: (a)
     ``build_llm_processor`` at the serving width with two engine actors
     at ``num_gpus`` 0.5 over 64 prompts in 4 blocks of 16: every row back
     with 32 tokens, from two processes other than this one, each
     launching the forward kernel, the ids equal to the bit to the same
     batches through ``_EngineUDF``s in this process, one for each actor
     fed that actor's batches in its order; tok/s over the
     batches' span and over the wall time against phase 5's, the actors'
     seconds to ready; (b) ``TorchTrainer`` with one GPU worker fed by
     ``range`` -> ``map_batches`` (token ids from a seed per row) ->
     seeded ``random_shuffle`` through ``streaming_split``'s coordinator
     into phase 9's step, 11 steps: the worker's and the coordinator's
     processes not this one, each batch equal to this process's run of
     the pipeline in order (sha256), the first loss equal to this
     process's step, 12 / 12 / 12 launches a step; tokens/s against phase
     10's, ``next(batch)`` p50, the in-process run's stats per op; (c)
     (b)'s pipeline written with ``write_tfrecords`` (one file a block,
     TFRecords encoded without tensorflow), registered with the data
     service as ``read_tfrecords`` -> ``map_batches``, and a
     ``TorchTrainer`` worker attached to it training phase 9's step over
     two epochs of 11 steps: each epoch's rows the pipeline's as a
     multiset (sha256 per row), the second epoch from the first-epoch
     cache (the job's ``data_jobs`` snapshot), the first loss equal to
     this process's step on the worker's first batch, 12 / 12 / 12
     launches a step, the coordinator and the service workers in
     processes other than this one with no CUDA context; the write's and
     the read's MB/s, the fit's and the worker's seconds, tokens/s per
     epoch against phase 10's, ``next(batch)`` p50 per epoch, the job's
     snapshot;
 10e. the autoscaler on the card (``run_autoscaler``): an
     ``AutoscalingCluster`` whose head advertises ``{"CPU": 2, "GPU": 0}``
     and whose one node type is ``{"CPU": 2, "GPU": 1}`` (max 1, idle
     5 s, a tick a second); ``build_llm_processor`` at the serving width
     with one engine actor at ``num_gpus`` 1 over ``read_mongo`` of 32
     prompts in 4 ``_id`` ranges, served by a wire-protocol server in this
     process: exactly one node launched, the actor in a process of that
     node (its pid not this one's, its node id the launched one), CUDA
     rows and forward launches in it, each row's prompt its document's,
     the ids equal to the bit to an ``_EngineUDF`` in this process fed
     the same batches in the actor's order, and the node terminated once
     idle, dead in the GCS, every process of it exited; the seconds from
     ``take_all`` to the node's joining, the actor's readiness and the
     last row, tok/s over the batches' span against phase 5's, and the
     seconds from the last row to the termination;
 10f. the observability plane (``run_observability``): the port's
     ``scripts/obs_smoke.py`` in a child process of its own, so that a
     fresh cluster starts with the phase's SLO rules, sampler cadence and
     metrics flush: a traced nested workload assembled into one tree, the
     dashboard's ``/metrics`` and APIs, a profile, goodput over a product
     on the card (MFU of the flag's 989 TFLOP/s), an engine at the serving
     width, the leak detector, a routed deployment, one request traced
     through a serve handle into a KV-tiered engine replica at
     ``num_gpus`` 0.5 rendered as one ``serving-anatomy`` tree with the
     replica's forward kernel launched once a layer for its full-miss
     prefill, ``smoke_ttft`` firing with that trace as its exemplar,
     ``smoke_queue`` firing and clearing, and the CLI's ``events`` /
     ``slo`` / ``top``: each section's line, the trace's spans and
     processes, the traced TTFT and ``llm.prefill`` ms, the sampler's
     tick ms, ``/metrics``' lines and bytes, the SLO seconds, goodput's
     buckets and MFU, and the replica's launches; the replica's warmup
     ids equal to the in-process engine's first ids;
 10g. the runtime's benchmarks on the card's host (``run_core_bench``),
     each through its entry point in a child process with a cluster or
     store daemon of its own: ``rtpu microbenchmark`` (its ten task,
     actor-call and put rates, its record written under
     ``chiprun_out/``), ``store_bench --reps 2`` (the store's eight put
     and get rates at 1KB and 10MB, one client and four),
     ``data_bench --images 256`` (the data service at one and four splits
     against four private pipelines, images/s, cache hits, failovers) and
     ``scale_bench --quick`` (20,000 tasks through the native raylet, 20
     actors, 4 placement groups over 3 nodes): every rate above 0,
     ``shared_1`` hitting the cache,
     ``shared_4`` failing over never, every task completed, actor alive
     and group placed, no committed ``BENCH_*.json`` changed; perf's sync
     actor call in us beside phase 6's no-op call p50 in this process;
 11. the MoE trainer at Mixtral 8x7B's widths cut to one layer, batch 1 x
     seq 4096 (``run_moe_trainer``), between two readings of the kernels
     at its attention shape (32 heads on 8 KV heads, head_dim 128): logits
     and aux against the plain attention (on the tokens both forwards
     route alike), the share of choices dropped by capacity, the first
     step against the plain attention, the loss falling, 2 / 1 / 1
     launches a step, timed and profiled steps with peak memory beside
     its reckoning, and the first step on a world-size-1 NCCL mesh
     through the zigzag dispatch, equal to the step without the mesh;
 12. the Llama-3 8B recipe at Llama-3 8B's widths cut to four layers,
     batch 2 x seq 8192 (``run_llama3_trainer``), between two readings of
     the kernels at its attention shape (32 heads on 8 KV heads, head_dim
     128, seq 8192; the plain versions at 8 heads on 2): first
     ``train_llama3_8b`` through ``DataParallelTrainer``, its controller
     and a worker actor of the port's runtime, with a committed checkpoint
     of the reckoned
     size (its save GB/s printed; written where there is room, then
     deleted) and steady tokens/s, model TFLOP/s and MFU in the result,
     and a dry-geometry run whose checkpoint is restored onto the card;
     then the same step in this process on a world-size-1 NCCL mesh: the
     first step against the plain attention (one KV head's group at a
     time), the loss falling, 8 / 4 / 4 launches a step, timed and
     profiled steps with peak memory beside its reckoning;
 13. online RLlib (``run_rllib``), the learners on the card and the env
     runners actors of the port's runtime, each in a process of its own
     with no CUDA context and its forward on the CPU (each reports its
     pid, its process's CUDA state and its forward's devices), one PPO
     runner actor's sample equal to the bit to the same sample in this
     process: (a) each learner update on the card
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
# small kernels launched and finished at the head of every profiled window
# before the measured calls: late in the script (after ``run_serve``) a
# window loses its first ~10 device events, and these take the loss
PROFILE_PAD = 64
WINDOW_MARK = "device_events.window"  # opens the measured calls


def device_events(fn, iters: int = 1, complete=bool):
    """Run ``fn`` ``iters`` times under the profiler; returns the
    device-side events' (name, total ms, count), largest first.  Only
    device events: the aten ops that launched them carry the same time
    again.  Each window opens with ``PROFILE_PAD`` small kernels, finished
    before the measured calls begin; only the device events that start
    after that are read.  A window is whole when every device event came
    ``iters`` times over (a whole multiple: a window that lost events is
    not) and ``complete`` accepts its rows (by default: at least one
    event).  A window that is not whole is profiled again, up to
    ``PROFILE_ATTEMPTS`` windows; returns [] when none was."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                pad.add_(1)
            torch.cuda.synchronize()
            with record_function(WINDOW_MARK):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        t0 = min(e.time_range.start for e in events
                 if e.name == WINDOW_MARK)
        totals = {}
        for e in events:  # the mark's own span on the device is not a kernel
            if (e.device_type == DeviceType.CUDA and e.name != WINDOW_MARK
                    and e.time_range.start >= t0):
                ms, n = totals.get(e.key, (0.0, 0))
                totals[e.key] = (ms + e.self_device_time_total / 1e3, n + 1)
        rows = [(k, ms, n) for k, (ms, n) in totals.items()]
        if all(c % iters == 0 for _, _, c in rows) and complete(rows):
            return sorted(rows, key=lambda r: -r[1])
        print(f"profiled window {attempt + 1} of {PROFILE_ATTEMPTS} is not "
              f"whole ({sum(c for _, _, c in rows)} device events after "
              f"the pad)", file=sys.stderr, flush=True)
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


def profiled_as(want):
    """``device_events``' ``complete`` for a window that must hold each
    kernel of ``want`` exactly as often as it says: a window in which the
    profiler lost one of their events is not whole."""
    return lambda rows: kernel_counts(rows, want) == want


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


def serving_engine():
    """bench.py's serving model (bench.py:85-90) at random weights from seed
    0 and its engine config (16 slots, 512 pages), started and warmed on
    the 128 and 1024 buckets, the burst and the sampled step; ``run_engine``
    and ``run_runtime``'s engine actor build it alike."""
    import torch

    from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, \
        SamplingParams
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, max_seq_len=1024, remat=False)
    state = llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    ecfg = EngineConfig(max_slots=16, num_pages=512, page_size=16,
                        max_seq_len=1024)
    engine = LLMEngine(state, cfg, ecfg)
    del state
    vocab = cfg.vocab_size
    engine.start()
    engine.generate(mix_prompt(1000, 100, vocab),
                    SamplingParams(max_tokens=8))
    engine.generate(mix_prompt(1001, 600, vocab),
                    SamplingParams(max_tokens=4))
    engine.generate(mix_prompt(1002, 128, vocab), SamplingParams(
        max_tokens=4, temperature=0.8, seed=1))
    torch.cuda.synchronize()
    return engine, cfg


def drain(req, timeout=300):
    """Every token id a submitted request streams, in order."""
    toks = []
    while True:
        item = req.out_queue.get(timeout=timeout)
        if item is None:
            return toks
        if isinstance(item, Exception):
            raise item
        toks.append(item)


# run_engine's request mix after its 3 unloaded requests: (seed, prompt
# length, max_tokens, temperature, sampling seed); the last request shares
# request 0's first 112 tokens (MIX_SHARED) and is submitted once request 0
# has its first token, so the prefix-cache suffix prefill runs
UNLOADED = [(2000 + i, 128, 4) for i in range(3)]
MIX = ([(i, 128, 32, 0.0, None) for i in range(16)]
       + [(100, 600, 32, 0.0, None), (101, 128, 32, 0.8, 7)])
MIX_SHARED = (0, 112, 102, 16, 32)  # (of seed, its tokens, seed, tokens, max)


def mix_shared_prompt(vocab: int):
    of, n_of, seed, n, _ = MIX_SHARED
    return mix_prompt(of, 128, vocab)[:n_of] + mix_prompt(seed, n, vocab)


def run_engine(report):
    import torch

    from ray_tpu_torch.llm import model as lm
    from ray_tpu_torch.llm.engine import SamplingParams
    from ray_tpu_torch.llm.paged_cache import CacheConfig, init_cache
    from ray_tpu_torch.ops import attention

    engine, cfg = serving_engine()
    kv_bytes = 2 * engine.cache_k.numel() * engine.cache_k.element_size()
    vocab = cfg.vocab_size

    def prompt(i, n):
        return mix_prompt(i, n, vocab)

    try:
        attention.flash_forward.launches = 0
        stats0 = engine.stats()
        ttfts = []
        unloaded_ids = []
        for seed, n, max_tokens in UNLOADED:  # one request at a time
            r = engine.submit(prompt(seed, n),
                              SamplingParams(max_tokens=max_tokens))
            ids = drain(r)
            if len(ids) != max_tokens:
                raise SystemExit("unloaded request streamed short")
            unloaded_ids.append(ids)
            ttfts.append(r.first_token_at - r.submitted_at)

        t0 = time.monotonic()
        reqs = [(engine.submit(prompt(seed, n), SamplingParams(
            max_tokens=m, temperature=temp, seed=sseed)), m)
            for seed, n, m, temp, sseed in MIX]
        # shares request 0's first 7 pages: admitted after request 0
        # registered its blocks, so the prefix-cache suffix prefill runs
        while reqs[0][0].first_token_at is None:
            time.sleep(0.001)
        reqs.append((engine.submit(mix_shared_prompt(vocab), SamplingParams(
            max_tokens=MIX_SHARED[-1])), MIX_SHARED[-1]))
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
           "unloaded_ids": unloaded_ids,
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


# ---------------------------------------------------------------------------
# phase: the port's runtime on the card (run_runtime)

RUNTIME_OBJECT_BYTES = 64 << 20  # the 64 MB bf16 tensor of (b) and (d)
RUNTIME_STORE_BYTES = 1 << 30
RUNTIME_ROUND_TRIPS = 100
RUNTIME_NOOP_CALLS = 100
RUNTIME_TIMEOUT_S = 600
# (e): the gauge pushed by the engine actor's flusher may trail its own
# reading by one allocation of the allocator's smallest block
RUNTIME_GAUGE_SLACK = 1 << 20


def byte_checksum(t):
    """Two exact integer sums over a tensor's bytes read as int16: equal
    bytes give equal sums on any device (int64 accumulation)."""
    import torch

    w = t.reshape(-1).view(torch.uint8).view(torch.int16).to(torch.int64)
    idx = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 65521
    return [int(w.sum()), int((w * idx).sum())]


def gauge_value(snapshot, family, pid, device=None):
    """The value of ``family`` pushed by process ``pid`` in a scheduler
    ``metrics_snapshot``, or None."""
    for proc in snapshot.get("app", []) or []:
        for m in proc:
            if m.get("name") != family:
                continue
            keys = list(m.get("tag_keys") or ())
            for tags, value in (m.get("values") or {}).items():
                tags = dict(zip(keys, tags))
                if tags.get("pid") != str(pid):
                    continue
                if device is not None and tags.get("device") != str(device):
                    continue
                return value
    return None


def runtime_checksum_task(box):
    """(b), in a ``num_gpus=1`` task: get the object, move it onto the card,
    checksum it there; twice, each get plus copy timed."""
    import torch

    import ray_tpu_torch as rt

    torch.zeros(1, device="cuda")  # the context, outside the timing
    readings, sums = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = rt.get(box[0], timeout=RUNTIME_TIMEOUT_S)
        dev = host.to("cuda")
        torch.cuda.synchronize()
        readings.append(time.perf_counter() - t0)
        sums = byte_checksum(dev)
        zero_copy = not host.is_cuda
        del host, dev
    return {"sums": sums, "get_h2d_s": readings, "host_view": zero_copy,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


class RuntimeEngineActor:
    """(c): the serving engine in an actor holding the card."""

    def __init__(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.engine, self.cfg = serving_engine()
        self.reqs = {}

    def ping(self):
        return None

    def reset_launches(self):
        from ray_tpu_torch.ops import attention

        attention.flash_forward.launches = 0

    def launches(self):
        from ray_tpu_torch.ops import attention

        return attention.flash_forward.launches

    def generate(self, key, prompt, max_tokens, temperature=0.0, seed=None,
                 after=None):
        """One request; ``after`` names a request whose first token must
        have come before this one is submitted."""
        from ray_tpu_torch.llm.engine import SamplingParams

        if after is not None:
            while (after not in self.reqs
                   or self.reqs[after].first_token_at is None):
                time.sleep(0.0005)
        r = self.engine.submit(prompt, SamplingParams(
            max_tokens=max_tokens, temperature=temperature, seed=seed))
        self.reqs[key] = r
        ids = drain(r)
        done = time.monotonic()
        return {"ids": ids, "engine_s": done - r.submitted_at,
                "ttft_s": r.first_token_at - r.submitted_at}

    def stop_engine(self):
        import torch

        self.engine.stop()
        torch.cuda.synchronize()
        return os.getpid()

    def memory(self):
        import torch

        stats = torch.cuda.memory_stats(0)
        return {"pid": os.getpid(),
                "current": stats["allocated_bytes.all.current"],
                "peak": stats["allocated_bytes.all.peak"]}


class RuntimeProducer:
    """(d): keeps a 64 MB bf16 tensor on the card under
    ``tensor_transport="device"``, and consumes its own objects."""

    def make(self, n_bytes, seed):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)
        t = torch.randn(n_bytes // 2, generator=gen, device="cuda",
                        dtype=torch.float32).to(torch.bfloat16)
        self.last = (t.data_ptr(), byte_checksum(t))
        return t

    def made(self):
        return self.last

    def allocated(self):
        import gc

        import torch

        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(0)

    def consume_own(self, box):
        """Get this actor's own device object: the resident tensor itself,
        with no store write and no relay pull."""
        from ray_tpu_torch._private import device_objects as dev_mod
        from ray_tpu_torch._private.worker import global_worker
        from ray_tpu_torch.experimental import get_device_object

        store = global_worker().store
        writes = []
        originals = {}
        for name in ("put", "put_parts", "create"):
            orig = getattr(store, name)
            originals[name] = orig

            def spy(*a, _name=name, _orig=orig, **kw):
                writes.append(_name)
                return _orig(*a, **kw)
            setattr(store, name, spy)
        relay = dev_mod.RELAY_PULLS
        try:
            out = get_device_object(box[0], timeout=RUNTIME_TIMEOUT_S)
        finally:
            for name, orig in originals.items():
                setattr(store, name, orig)
        return {"writes": writes, "relay_delta": dev_mod.RELAY_PULLS - relay,
                "data_ptr": out.data_ptr(), "is_cuda": out.is_cuda}


class RuntimeConsumer:
    """(d): another process pulls the device object over the host relay."""

    def pull(self, box):
        import torch  # noqa: F401  (imported before the timing)

        import ray_tpu_torch as rt
        from ray_tpu_torch._private import device_objects as dev_mod

        relay = dev_mod.RELAY_PULLS
        t0 = time.perf_counter()
        out = rt.get(box[0], timeout=RUNTIME_TIMEOUT_S)
        secs = time.perf_counter() - t0
        return {"sums": byte_checksum(out), "secs": secs,
                "relay_delta": dev_mod.RELAY_PULLS - relay,
                "device": str(out.device), "dtype": str(out.dtype),
                "numel": out.numel(), "pid": os.getpid()}


def run_runtime(report):
    """Phase 6: the port's runtime on the card (after run_engine, whose
    ids and tok/s it is held to)."""
    import numpy as np
    import torch

    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import device_objects as dev_mod
    from ray_tpu_torch._private import direct
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private.node import session_root
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.experimental import free_device_object

    res = {}
    t_phase = time.monotonic()
    # (a) the runtime: the node counts the card
    node = rt.init(num_cpus=8, object_store_memory=RUNTIME_STORE_BYTES)
    try:
        total = rt.cluster_resources()
        lanes = {"rtpu_core": direct.native_core() is not None,
                 "native_gcs": node._gcs_proc is not None,
                 "native_store": node.store_server is not None,
                 "native_raylet": bool(node.scheduler._raylet_native)}
        res.update(resources=total, session_root=session_root(),
                   session_dir=node.session_dir, lanes=lanes)
        print(f"runtime: session {node.session_dir} (root {session_root()});"
              f" resources {total}; lanes {lanes}", flush=True)
        if total.get("GPU") != 1:
            raise SystemExit(f"the node reports {total.get('GPU')} GPUs, "
                             "not 1")
        parts_s = {"a": time.monotonic() - t_phase}

        # (b) CUDA tensors through the object store
        gen = torch.Generator(device="cuda").manual_seed(5)
        src = torch.randn(RUNTIME_OBJECT_BYTES // 2, generator=gen,
                          device="cuda").to(torch.bfloat16)
        want = byte_checksum(src)
        put_s, refs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refs.append(rt.put(src))
            put_s.append(time.perf_counter() - t0)
        task = rt.remote(num_gpus=1)(runtime_checksum_task)
        got = rt.get(task.remote([refs[1]]), timeout=RUNTIME_TIMEOUT_S)
        if got["sums"] != want:
            raise SystemExit(f"the 64 MB object's bytes differ on the card: "
                             f"{got['sums']} != {want}")
        # the same D2H without the store: into fresh pageable pages (each
        # touched first by the copy), again into the same pages, and into
        # pinned memory; splits put's time into first touch and the copy
        flat = src.reshape(-1).view(torch.uint8)
        pageable = torch.empty(flat.numel(), dtype=torch.uint8)
        pinned = torch.empty(flat.numel(), dtype=torch.uint8,
                             pin_memory=True)
        d2h = {}
        for key, dst in (("pageable_fresh", pageable),
                         ("pageable_warm", pageable), ("pinned", pinned)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(flat)
            torch.cuda.synchronize()
            d2h[key] = RUNTIME_OBJECT_BYTES / 1e9 / (time.perf_counter() - t0)
        del flat, pageable, pinned
        small = torch.arange(1024, dtype=torch.float32)
        trips = []
        for _ in range(RUNTIME_ROUND_TRIPS):
            t0 = time.perf_counter()
            back = rt.get(rt.put(small), timeout=RUNTIME_TIMEOUT_S)
            trips.append(time.perf_counter() - t0)
        if not torch.equal(back, small):
            raise SystemExit("a small CPU tensor came back changed")
        gb = RUNTIME_OBJECT_BYTES / 1e9
        res["store"] = {
            "bytes": RUNTIME_OBJECT_BYTES, "checksum": want,
            "put_gbps": [gb / s for s in put_s],
            "get_h2d_gbps": [gb / s for s in got["get_h2d_s"]],
            "task_visible_devices": got["visible"],
            "d2h_gbps": d2h,
            "small_round_trip_ms": {
                "p50": 1e3 * float(np.percentile(trips, 50)),
                "p90": 1e3 * float(np.percentile(trips, 90))}}
        del refs, src
        parts_s["b"] = time.monotonic() - t_phase
        print(f"runtime store: 64 MB bf16 put (D2H into the store) "
              f"{res['store']['put_gbps'][0]:.3f} / "
              f"{res['store']['put_gbps'][1]:.3f} GB/s; get + H2D in a "
              f"num_gpus=1 task {res['store']['get_h2d_gbps'][0]:.3f} / "
              f"{res['store']['get_h2d_gbps'][1]:.3f} GB/s, bytes equal; "
              f"the same D2H outside the store: fresh pageable "
              f"{d2h['pageable_fresh']:.3f}, warm pageable "
              f"{d2h['pageable_warm']:.3f}, pinned {d2h['pinned']:.3f} "
              f"GB/s; "
              f"4 KB CPU tensor round trip p50 "
              f"{res['store']['small_round_trip_ms']['p50']:.4f} ms, p90 "
              f"{res['store']['small_round_trip_ms']['p90']:.4f} ms",
              flush=True)

        # (c) an actor holding the card serves run_engine's requests
        Engine = rt.remote(num_gpus=1, max_concurrency=32)(
            RuntimeEngineActor)
        actor = Engine.remote()
        rt.get(actor.ping.remote(), timeout=RUNTIME_TIMEOUT_S)
        calls = []
        for _ in range(RUNTIME_NOOP_CALLS):
            t0 = time.perf_counter()
            rt.get(actor.ping.remote(), timeout=RUNTIME_TIMEOUT_S)
            calls.append(time.perf_counter() - t0)
        rt.get(actor.reset_launches.remote(), timeout=RUNTIME_TIMEOUT_S)
        vocab = 32_000
        unloaded, overhead = [], []
        for k, (seed, n, m) in enumerate(UNLOADED):
            t0 = time.perf_counter()
            out = rt.get(actor.generate.remote(
                f"u{k}", mix_prompt(seed, n, vocab), m),
                timeout=RUNTIME_TIMEOUT_S)
            overhead.append(time.perf_counter() - t0 - out["engine_s"])
            unloaded.append(out["ids"])
        engine_ids = report["engine"]["unloaded_ids"]
        if unloaded != engine_ids:
            raise SystemExit(f"the actor's unloaded ids {unloaded} differ "
                             f"from run_engine's {engine_ids}")
        t0 = time.monotonic()
        pending = [actor.generate.remote(
            f"m{j}", mix_prompt(seed, n, vocab), m, temp, sseed)
            for j, (seed, n, m, temp, sseed) in enumerate(MIX)]
        pending.append(actor.generate.remote(
            "shared", mix_shared_prompt(vocab), MIX_SHARED[-1], after="m0"))
        outs = rt.get(pending, timeout=RUNTIME_TIMEOUT_S)
        wall = time.monotonic() - t0
        wants = [m for _, _, m, _, _ in MIX] + [MIX_SHARED[-1]]
        short = [(j, len(o["ids"]), w) for j, (o, w)
                 in enumerate(zip(outs, wants)) if len(o["ids"]) != w]
        if short:
            raise SystemExit(f"the actor's requests streamed short: {short}")
        launches = rt.get(actor.launches.remote(), timeout=RUNTIME_TIMEOUT_S)
        if launches <= 0:
            raise SystemExit("the engine actor never launched the forward "
                             "kernel")
        n_tok = sum(len(o["ids"]) for o in outs)
        ratio = (n_tok / wall) / report["engine"]["output_tok_s"]
        res["actor"] = {
            "noop_call_ms": {"p50": 1e3 * float(np.percentile(calls, 50)),
                             "p90": 1e3 * float(np.percentile(calls, 90))},
            "unloaded_ids_equal": True,
            "request_overhead_ms": [1e3 * o for o in overhead],
            "requests": len(outs), "tokens": n_tok, "wall_s": wall,
            "output_tok_s": n_tok / wall, "of_run_engine": ratio,
            "flash_launches": launches}
        print(f"runtime actor: no-op call p50 "
              f"{res['actor']['noop_call_ms']['p50']:.4f} ms, p90 "
              f"{res['actor']['noop_call_ms']['p90']:.4f} ms; 3 unloaded "
              f"requests' ids equal run_engine's, call overhead "
              f"{', '.join(f'{1e3 * o:.3f}' for o in overhead)} ms; "
              f"{len(outs)} requests, {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} output tok/s ({ratio:.4f} of run_engine's);"
              f" forward launches in the actor {launches}", flush=True)

        parts_s["c"] = time.monotonic() - t_phase
        # (e) device telemetry of the engine actor, through the scheduler
        pid = rt.get(actor.stop_engine.remote(), timeout=RUNTIME_TIMEOUT_S)
        tele = profiling._DeviceTelemetry
        ctx = global_worker()
        deadline = time.monotonic() + 60
        while True:
            before = rt.get(actor.memory.remote(), timeout=RUNTIME_TIMEOUT_S)
            snap = ctx.rpc("metrics_snapshot", {})
            after = rt.get(actor.memory.remote(), timeout=RUNTIME_TIMEOUT_S)
            in_use = gauge_value(snap, tele.IN_USE, pid, 0)
            peak = gauge_value(snap, tele.PEAK, pid, 0)
            lo = min(before["current"], after["current"])
            hi = max(before["current"], after["current"])
            if (in_use is not None
                    and lo - RUNTIME_GAUGE_SLACK <= in_use
                    <= hi + RUNTIME_GAUGE_SLACK):
                break
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"the engine actor's device gauges did not reach the "
                    f"scheduler: in use {in_use}, own {lo}..{hi}")
            time.sleep(0.5)
        builds = gauge_value(snap, tele.BUILDS, pid)
        build_s = gauge_value(snap, tele.BUILD_SECONDS, pid)
        res["telemetry"] = {"pid": pid, "gauge_in_use": in_use,
                            "gauge_peak": peak, "own_current": lo,
                            "own_peak": after["peak"],
                            "kernel_builds": builds,
                            "kernel_build_s": build_s}
        print(f"runtime telemetry: engine actor pid {pid} device bytes in "
              f"use {in_use} (own reading {lo}), peak {peak} (own "
              f"{after['peak']}); kernel builds {builds} taking {build_s} s",
              flush=True)
        rt.kill(actor)
        parts_s["e"] = time.monotonic() - t_phase

        # (d) device objects
        Producer = rt.remote(num_gpus=1, max_concurrency=2)(RuntimeProducer)
        Consumer = rt.remote(RuntimeConsumer)
        prod, cons = Producer.remote(), Consumer.remote()
        base = rt.get(prod.allocated.remote(), timeout=RUNTIME_TIMEOUT_S)
        ref = prod.make.options(tensor_transport="device").remote(
            RUNTIME_OBJECT_BYTES, 9)
        rt.wait([ref], timeout=RUNTIME_TIMEOUT_S)
        ptr, sums = rt.get(prod.made.remote(), timeout=RUNTIME_TIMEOUT_S)
        relay = rt.get(cons.pull.remote([ref]), timeout=RUNTIME_TIMEOUT_S)
        if relay["sums"] != sums or relay["relay_delta"] != 1:
            raise SystemExit(f"the relayed device object differs: {relay} "
                             f"against {sums}")
        own = rt.get(prod.consume_own.remote([ref]),
                     timeout=RUNTIME_TIMEOUT_S)
        if own["writes"] or own["relay_delta"] or own["data_ptr"] != ptr:
            raise SystemExit(f"the same-process get was not the resident "
                             f"tensor: {own} (resident data_ptr {ptr})")
        held = rt.get(prod.allocated.remote(), timeout=RUNTIME_TIMEOUT_S)
        if not free_device_object(ref):
            raise SystemExit("free_device_object found nothing resident")
        freed = rt.get(prod.allocated.remote(), timeout=RUNTIME_TIMEOUT_S)
        if held - freed < RUNTIME_OBJECT_BYTES:
            raise SystemExit(f"freeing the device object released "
                             f"{held - freed} bytes, not 64 MB")
        try:
            rt.get(ref, timeout=RUNTIME_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001
            if "no longer resident" not in str(e):
                raise
        else:
            raise SystemExit("a get after free_device_object succeeded")
        res["device_objects"] = {
            "relay_gbps": gb / relay["secs"], "relay": relay,
            "same_process": own, "resident_data_ptr": ptr,
            "allocated_before": base, "allocated_held": held,
            "allocated_freed": freed, "released": held - freed}
        print(f"runtime device objects: relay to another process "
              f"{gb / relay['secs']:.3f} GB/s ({relay['device']} "
              f"{relay['dtype']}), checksum equal, relay pulls +1; same "
              f"process: the resident tensor (data_ptr equal), 0 store "
              f"writes, relay pulls +0; free released "
              f"{(held - freed) / 2**20:.1f} MiB, a later get raises",
              flush=True)
        rt.kill(prod)
        rt.kill(cons)
        parts_s["d"] = time.monotonic() - t_phase
        res["parts_s"] = parts_s
        print(f"runtime phase: seconds from its start at the end of each "
              f"part {parts_s}", flush=True)
    finally:
        rt.shutdown()
    res["phase_s"] = time.monotonic() - t_phase
    report["runtime"] = res
    return res["actor"]["flash_launches"]


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
# The reference's ladder with its top rung cut from 1024 requests to 256
# (concurrency and width kept): at 1024 the phase took 98.8-199.2 s with
# the host's speed against its 150 s budget, and at 512 the whole script
# ran past its 1200 s limit on a slow host (NVIDIA H100 80GB HBM3).  Its
# middle rung (16, 256) is left out for the script's time: every gate
# reads the top rung, which stays.
SERVE_LADDER = ((4, 128), (32, 256))
# the profiled rerun of the top prefix-aware cell runs 1/4 of its requests
SERVE_PROFILED_SHARE = 4


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
    prof = serve_busy_share(sb, model, n // SERVE_PROFILED_SHARE, c,
                            top_cell["wall_s"] / 16)
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


# The serve runtime at the serving width (``run_serve``): the port's own
# runtime with the card (``"GPU": 1``), ``build_openai_app`` with two
# ``LLMServer`` replicas at ``num_gpus`` 0.5 each (the scheduler grants
# ``CUDA_VISIBLE_DEVICES`` only for whole GPUs, so a half-GPU replica sees
# the node's card as ``cuda:0``), each holding its engine in its own
# process behind the controller, the ``OpenAIRouter`` ingress and the HTTP
# proxy; then ``build_pd_openai_app`` with one prefill and one decode
# replica.  Kernel launches are read in each replica's own process.
SERVE_APP = "serving"
SERVE_MODEL_ID = "serving-768"
SERVE_TIMEOUT_S = 300
SERVE_START_S = 240  # serve.run's wait for the replicas to be RUNNING
SERVE_KILL = {"requests": 48, "concurrency": 8, "families": 6,
              "kill_frac": 0.45}  # serve_bench's kill rung, cut to 48
PD_MAX_TOKENS = 16


def serve_model_loader():
    """``serving_engine``'s model, in a replica's process: ``bench.py``'s
    serving width at random weights from seed 0, on the card."""
    import torch

    from ray_tpu_torch.models import llama

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.LlamaConfig(
        vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, max_seq_len=1024, remat=False)
    return llama.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda"), cfg


def serve_llm_config(model_id=SERVE_MODEL_ID, replicas=2,
                     default_max_tokens=64):
    from ray_tpu_torch.llm import EngineConfig, LLMConfig

    return LLMConfig(
        model_id=model_id, model_loader=serve_model_loader,
        engine_config=EngineConfig(max_slots=16, num_pages=512,
                                   page_size=16, max_seq_len=1024),
        default_max_tokens=default_max_tokens, num_replicas=replicas,
        ray_actor_options={"num_gpus": 0.5})


# Functions run inside a replica's process through ``__rtpu_apply__``;
# ``inst`` is the ``ReplicaActor``, ``inst._user`` its deployment.


def replica_launches(inst, reset=False):
    """The forward kernel's launches in this process (then zeroed)."""
    from ray_tpu_torch.ops import attention

    n = attention.flash_forward.launches
    if reset:
        attention.flash_forward.launches = 0
    return n


def replica_identity(inst):
    """The replica's pid, whether it holds a CUDA context, and the bytes
    of its engine's weights."""
    import torch

    weights, devices = 0, set()
    stack = [inst._user._engine.state]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            weights += node.numel() * node.element_size()
            devices.add(str(node.device))
    return {"pid": os.getpid(), "cuda": torch.cuda.is_initialized(),
            "devices": sorted(devices), "weight_bytes": weights,
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}


def process_cuda(inst):
    """(pid, whether this process initialised CUDA) for a system actor."""
    torch = sys.modules.get("torch")
    return os.getpid(), bool(torch is not None
                             and torch.cuda.is_initialized())


def replica_generate(inst, prompt, kwargs):
    return inst._user.generate_tokens(list(prompt), **kwargs)


def replica_engine_stats(inst):
    st = inst._user.engine_stats()
    st["replica_total"] = inst._total
    return st


def replica_profile_open(inst):
    """Open a device-activity profiler window on a thread of this process
    (opened and closed on that thread); returns once it records."""
    import threading

    from ray_tpu_torch.ops import attention

    started, stop, box = threading.Event(), threading.Event(), {}

    def window():
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            box["launches"] = attention.flash_forward.launches
            t0 = time.perf_counter()
            started.set()
            stop.wait(SERVE_TIMEOUT_S)
            torch.cuda.synchronize()
            box["window_ms"] = (time.perf_counter() - t0) * 1e3
            box["launches"] = attention.flash_forward.launches - box[
                "launches"]
        box["rows"] = sorted(((e.key, e.self_device_time_total / 1e3,
                               e.count) for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA),
                             key=lambda r: -r[1])

    t = threading.Thread(target=window, daemon=True)
    t.start()
    started.wait(SERVE_TIMEOUT_S)
    inst.__dict__["_smoke_profile"] = (t, stop, box)
    return os.getpid()


def replica_profile_stop(inst):
    """End the window's recording (its trace is read by
    ``replica_profile_close``)."""
    inst.__dict__["_smoke_profile"][1].set()


def replica_profile_close(inst):
    """The window's wall and busy ms, and whether it is whole (it holds
    one forward-kernel event for every launch counted in it, and at
    least one)."""
    t, stop, box = inst.__dict__.pop("_smoke_profile")
    t.join(SERVE_TIMEOUT_S)
    rows = box.get("rows", [])
    events = sum(c for k, _, c in rows if "flash_fwd_mma_kernel" in k)
    return {"window_ms": box["window_ms"],
            "busy_ms": sum(r[1] for r in rows),
            "launches": box["launches"], "kernel_events": events,
            "whole": events == box["launches"] > 0,
            "top": [{"kernel": k[:60], "ms": ms, "count": c}
                    for k, ms, c in rows[:4]]}


def pd_reference(texts):
    """(d)'s reference, in a task of the runtime: one engine of
    ``run_engine``'s model and config over the node's store tier, which
    pulls the spines the prefill replica sealed as the decode replica did,
    and a cold engine without a tier (its ids are printed beside them);
    each serves ``texts`` in order as the decode replica did."""
    import torch

    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.llm import kv_tier as kt
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    state, cfg = serve_model_loader()
    ecfg = serve_llm_config().engine_config
    ref = {}
    for key, tier in (("tier", kt.KVTier(
            kt.WorkerStoreBackend(global_worker()),
            kt.GcsDirectory(global_worker()))), ("cold", None)):
        eng = LLMEngine(state, cfg, ecfg, kv_tier=tier)
        eng.start()
        try:
            ref[key] = [eng.generate(tok.encode(t), SamplingParams(
                max_tokens=PD_MAX_TOKENS, stop_token_ids=(tok.eos_id,)))
                for t in texts]
            ref[key + "_pulls"] = eng.stats()["kv_pulls"]
        finally:
            eng.stop()
    torch.cuda.synchronize()
    ref["pid"] = os.getpid()
    return ref


def pid_exited(pid: int) -> bool:
    """The process is gone or a zombie awaiting its parent's reap."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def card_runtime(store_bytes: int = None):
    """Start the port's runtime on this host, the card counted as
    ``"GPU": 1``, with a store of ``store_bytes`` (RUNTIME_STORE_BYTES
    by default); its worker processes import the checkout
    (``PYTHONPATH``).  Returns the node; the caller shuts it down."""
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p and p != HERE])
    import ray_tpu_torch as rt

    node = rt.init(num_cpus=8,
                   object_store_memory=store_bytes or RUNTIME_STORE_BYTES)
    if rt.cluster_resources().get("GPU") != 1:
        rt.shutdown()
        raise SystemExit("the node does not count the card as 1 GPU")
    return node


def keep_session_logs(node, label: str) -> str:
    """Copy a shut-down session's worker and GCS logs under OUT_DIR (the
    session lives in the machine's temporary directory); returns where."""
    import shutil

    dest = os.path.join(OUT_DIR, f"{label}_logs")
    shutil.copytree(os.path.join(node.session_dir, "logs"), dest,
                    dirs_exist_ok=True)
    for name in os.listdir(node.session_dir):
        if name.endswith((".err", ".out", ".log")):
            shutil.copy(os.path.join(node.session_dir, name), dest)
    return dest


def wait_exited(pids, what: str, within: float = 60.0) -> float:
    """Wait until every process in ``pids`` (each held the card) has
    exited; returns the seconds waited."""
    t0 = time.monotonic()
    while not all(pid_exited(pid) for pid in pids):
        if time.monotonic() - t0 > within:
            raise SystemExit(f"{what}: processes that held the card outlived "
                             f"the runtime: {sorted(pids)}")
        time.sleep(0.2)
    return time.monotonic() - t0


def serve_mix_window(port, base, vocab, stream):
    """``run_engine``'s 19-request mix through the HTTP proxy as
    ``/v1/completions``, one client thread each, ``ignore_eos`` holding
    each to its ``max_tokens``; ``base`` offsets the prompt seeds so that
    every window starts cold.  The request sharing request 0's first 7
    pages is sent once request 0 has its first token (streamed) or its
    response (whole).  Returns each request's (tokens, finish reason,
    TTFT s or None, stream s from its first to its last token or None),
    and the window's wall seconds, first send to last byte."""
    import threading

    import requests

    url = f"http://127.0.0.1:{port}/v1/completions"
    bodies = [{"prompt": mix_prompt(base + seed, n, vocab), "max_tokens": m,
               "temperature": temp, "seed": sseed}
              for seed, n, m, temp, sseed in MIX]
    of, n_of, seed, n, m = MIX_SHARED
    bodies.append({"prompt": mix_prompt(base + of, 128, vocab)[:n_of]
                   + mix_prompt(base + seed, n, vocab), "max_tokens": m})
    first = threading.Event()
    out = [None] * len(bodies)

    def client(i):
        row = (0, None, None, None)
        try:
            if i == len(bodies) - 1:
                first.wait(SERVE_TIMEOUT_S)
            body = dict(bodies[i], ignore_eos=True, stream=stream)
            t0 = time.perf_counter()
            with requests.post(url, json=body, timeout=SERVE_TIMEOUT_S,
                               stream=stream) as r:
                if not stream:
                    got = r.json()
                    row = (got["usage"]["completion_tokens"],
                           got["choices"][0]["finish_reason"], None, None)
                else:
                    n_tok, reason, t_first, t_last = 0, None, None, None
                    for line in r.iter_lines():
                        if not line or line == b"data: [DONE]":
                            continue
                        choice = json.loads(line[len(b"data: "):])[
                            "choices"][0]
                        reason = choice["finish_reason"]
                        if reason is None:
                            n_tok += 1
                            t_last = time.perf_counter()
                            if t_first is None:
                                t_first = t_last
                                if i == 0:
                                    first.set()
                    row = (n_tok, reason,
                           None if t_first is None else t_first - t0,
                           None if t_first is None else t_last - t_first)
        except Exception as e:  # noqa: BLE001 — reported as the reason
            row = (0, repr(e), None, None)
        finally:
            if i == 0:
                first.set()
            out[i] = row

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(SERVE_TIMEOUT_S)
    wants = [m for _, _, m, _, _ in MIX] + [MIX_SHARED[-1]]
    return out, time.monotonic() - t0, wants


def run_serve(report):
    """Phase 8b: the serve runtime on the card (after ``run_serve_bench``;
    ``run_engine``'s ids and rate are the reference).  (a)
    ``build_openai_app`` at the serving width with two replicas at
    ``num_gpus`` 0.5: RUNNING, each replica's process holding the card
    (its device-memory gauge in the scheduler's ``metrics_snapshot`` over
    its weights' bytes, its pid not this script's, 0 kernel builds: it
    loads phase 1's build), the proxy and the controller without CUDA,
    and ``run_engine``'s 3 unloaded requests giving its ids bit for bit on
    each replica and through the deployment's handle (the byte tokenizer's
    text drops ids past 258, so the ids come from ``generate_tokens``;
    the same requests through the ingress stream their full counts);
    (b) the 19-request mix through the HTTP proxy, whole responses and
    SSE streams: every request full, both replicas serving, the forward
    kernel launched in each replica's process; its output tok/s beside
    ``run_engine``'s and ``run_frontends``' server rate, TTFT, each
    replica's share, and each replica's device-busy share over a rerun
    (printed, not gated); (c) replica death with the KV tier on:
    ``serve_bench``'s kill-rung traffic, 48 requests at concurrency 8
    through the ingress, the replica holding the most families killed
    after 45% complete: all complete without an error, the controller
    reports the death and starts a replacement on the card, the killed
    process exits, and the survivor or the replacement pulls from the
    store tier; (d) ``build_pd_openai_app`` with one prefill and one
    decode replica: 4 prompts (the first warms both replicas, untimed)
    handed off through the store tier (``kv_in_tier``), the decode replica
    pulling, ids equal to a single engine's (``run_engine``'s model) that
    pulls the same spines from the same tier, bit for bit.  Returns the
    forward kernel's launches in the replicas' processes."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import profiling
    from ray_tpu_torch._private import serve_bench as sb
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.llm import build_openai_app, build_pd_openai_app
    from ray_tpu_torch.llm.paged_cache import PrefixCache
    from ray_tpu_torch.llm.tokenizer import ByteTokenizer

    tele = profiling._DeviceTelemetry
    vocab = 32_000
    res, launches = {}, {}
    card_pids = set()  # every process of the phase that held the card
    t_phase = time.monotonic()

    def call(actor, fn, *args):
        return rt.get(actor.__rtpu_apply__.remote(fn, *args),
                      timeout=SERVE_TIMEOUT_S)

    def call_all(actors, fn):
        """``fn`` in every actor's process at once."""
        return rt.get([a.__rtpu_apply__.remote(fn) for a in actors],
                      timeout=SERVE_TIMEOUT_S)

    def replicas(app, deployment):
        controller = rt.get_actor("SERVE_CONTROLLER")
        return rt.get(controller.get_replicas.remote(app, deployment),
                      timeout=SERVE_TIMEOUT_S)

    def snapshot():
        return global_worker().rpc("metrics_snapshot", {})

    def on_card(reps, what):
        """Each replica's identity, with its device-memory gauge and
        kernel-build counter as its flusher pushed them (a replica's
        first push may predate its model: wait for one that holds it)."""
        rows = [call(r, replica_identity) for r in reps]

        def holds(row):
            return (row["gauge_in_use"] is not None
                    and row["kernel_builds"] is not None
                    and row["gauge_in_use"] > row["weight_bytes"] > 0)

        deadline = time.monotonic() + 60
        while True:
            snap = snapshot()
            for row in rows:
                row["gauge_in_use"] = gauge_value(snap, tele.IN_USE,
                                                  row["pid"], 0)
                row["kernel_builds"] = gauge_value(snap, tele.BUILDS,
                                                   row["pid"])
            if all(holds(row) for row in rows) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.5)
        card_pids.update(row["pid"] for row in rows)
        bad = [row for row in rows if not (
            holds(row) and row["cuda"] and row["pid"] != os.getpid()
            and row["devices"] == ["cuda:0"]
            and row["kernel_builds"] == 0)]
        if bad:
            raise SystemExit(f"{what}: a replica does not hold the card as "
                             f"it should: {bad}")
        return rows

    node = card_runtime()
    try:
        # (a) the application reaches RUNNING with both replicas on the card
        t0 = time.monotonic()
        serve.run(build_openai_app(serve_llm_config()), name=SERVE_APP,
                  route_prefix="/", _blocking_timeout_s=SERVE_START_S)
        running_s = time.monotonic() - t0
        server_dep = f"LLMServer:{SERVE_MODEL_ID}"
        reps = replicas(SERVE_APP, server_dep)["replicas"]
        if len(reps) != 2:
            raise SystemExit(f"{len(reps)} LLMServer replicas, not 2")
        for r in reps:
            call(r, replica_launches, True)
        ident = on_card(reps, "(a)")
        system = {name: call(rt.get_actor(name), process_cuda)
                  for name in ("SERVE_CONTROLLER", "SERVE_PROXY")}
        if any(cuda for _, cuda in system.values()):
            raise SystemExit(f"a serve system actor initialised CUDA: "
                             f"{system}")
        server = serve.DeploymentHandle(SERVE_APP, server_dep)
        ingress = serve.get_app_handle(SERVE_APP)
        want = report["engine"]["unloaded_ids"]
        through_handle = [server.generate_tokens.remote(
            mix_prompt(seed, n, vocab), max_tokens=m).result(
                timeout_s=SERVE_TIMEOUT_S) for seed, n, m in UNLOADED]
        per_replica = [[call(r, replica_generate, mix_prompt(seed, n, vocab),
                             {"max_tokens": m}) for seed, n, m in UNLOADED]
                       for r in reps]
        tok = ByteTokenizer()
        via_ingress = []
        for (seed, n, m), ids in zip(UNLOADED, want):
            resp = ingress.handle_http.remote({
                "path": "/v1/completions", "body": {
                    "prompt": mix_prompt(seed, n, vocab), "max_tokens": m,
                    "ignore_eos": True}}).result(timeout_s=SERVE_TIMEOUT_S)
            via_ingress.append(
                resp["usage"]["completion_tokens"] == m
                and resp["choices"][0]["text"] == tok.decode(ids))
        res["a"] = {"running_s": running_s, "replicas": ident,
                    "system_actors": {k: {"pid": v[0], "cuda": v[1]}
                                      for k, v in system.items()},
                    "ids_through_handle_equal": through_handle == want,
                    "ids_per_replica_equal": [ids == want
                                              for ids in per_replica],
                    "ingress_full_and_text_equal": via_ingress}
        print(f"serve (a): build_openai_app RUNNING in {running_s:.1f} s; "
              + "; ".join(f"replica pid {r['pid']} on {r['devices']} "
                          f"(CUDA_VISIBLE_DEVICES {r['visible']}), device "
                          f"bytes in use {r['gauge_in_use']:.0f} over its "
                          f"weights' {r['weight_bytes']}, kernel builds "
                          f"{r['kernel_builds']:.0f}" for r in ident)
              + f"; script pid {os.getpid()}; controller and proxy CUDA "
              f"{[v[1] for v in system.values()]}; run_engine's 3 unloaded "
              f"ids equal through the handle: {through_handle == want}, on "
              f"each replica: {res['a']['ids_per_replica_equal']}; through "
              f"the ingress full with equal text: {via_ingress}",
              flush=True)
        if not (through_handle == want and all(
                ids == want for ids in per_replica) and all(via_ingress)):
            raise SystemExit(f"the replicas' ids differ from run_engine's: "
                             f"{through_handle} / {per_replica} against "
                             f"{want}")

        # (b) the mix through the HTTP proxy, each replica warmed first as
        # run_engine's engine is (the 100- and 600-token prompts, a
        # sampled request)
        for r in reps:
            for seed, n, kw in ((1000, 100, {"max_tokens": 8}),
                                (1001, 600, {"max_tokens": 4}),
                                (1002, 128, {"max_tokens": 4,
                                             "temperature": 0.8,
                                             "seed": 1})):
                call(r, replica_generate, mix_prompt(seed, n, vocab), kw)
        port = serve.http_port()
        windows = {}
        for key, base, stream in (("whole", 600, False),
                                  ("sse", 900, True)):
            before = [call(r, replica_engine_stats)["replica_total"]
                      for r in reps]
            rows, wall, wants = serve_mix_window(port, base, vocab, stream)
            after = [call(r, replica_engine_stats)["replica_total"]
                     for r in reps]
            n_tok = sum(row[0] for row in rows)
            short = [(i, row[0], row[1], w) for i, (row, w)
                     in enumerate(zip(rows, wants))
                     if (row[0], row[1]) != (w, "length")]
            win = {"requests": len(rows), "tokens": n_tok, "wall_s": wall,
                   "output_tok_s": n_tok / wall,
                   "per_replica": [a - b for a, b in zip(after, before)],
                   "short": short}
            if stream:
                ttft = [row[2] for row in rows if row[2] is not None]
                rates = [(row[0] - 1) / row[3] for row in rows
                         if row[3] and row[0] > 1]
                win.update(ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
                           ttft_p90_ms=1e3 * float(np.percentile(ttft, 90)),
                           stream_tok_s_p50=float(np.median(rates)))
            windows[key] = win
        engine_rate = report["engine"]["output_tok_s"]
        server_rates = [w["output_tok_s"]
                        for w in report["frontends"]["server_load"]]
        # the device-busy share inside each replica over one rerun (more
        # while a replica's window lost kernel events): both windows open
        # before the first request and stop after the last response
        prof = None
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            call_all(reps, replica_profile_open)
            rows, wall, _ = serve_mix_window(port, 1200 + 300 * attempt,
                                             vocab, False)
            call_all(reps, replica_profile_stop)
            prof = call_all(reps, replica_profile_close)
            if all(p["whole"] for p in prof):
                break
        b_launches = [call(r, replica_launches, True) for r in reps]
        res["b"] = {"windows": windows, "run_engine_tok_s": engine_rate,
                    "run_frontends_server_tok_s": server_rates,
                    "profiled": {"attempts": attempt, "replicas": prof},
                    "launches_a_b": b_launches}
        launches["a_b"] = sum(b_launches)
        for key, win in windows.items():
            print(f"serve (b) {key}: {win['requests']} concurrent requests "
                  f"through the proxy, {win['tokens']} tokens in "
                  f"{win['wall_s']:.3f} s = {win['output_tok_s']:.1f} output "
                  f"tok/s ({win['output_tok_s'] / engine_rate:.4f} of "
                  f"run_engine's {engine_rate:.1f}; run_frontends' server "
                  f"{', '.join(f'{x:.1f}' for x in server_rates)}); requests "
                  f"per replica {win['per_replica']}"
                  + (f"; TTFT p50 {win['ttft_p50_ms']:.2f} ms, p90 "
                     f"{win['ttft_p90_ms']:.2f} ms; a stream's tok/s after "
                     f"its first token p50 {win['stream_tok_s_p50']:.1f}"
                     if key == "sse" else ""), flush=True)
        print("serve (b) device-busy share in each replica's process over "
              f"a rerun (window {attempt}): " + "; ".join(
                  (f"{p['busy_ms']:.1f} ms busy of {p['window_ms']:.1f} = "
                   f"{p['busy_ms'] / p['window_ms']:.4f} ({p['launches']} "
                   f"forward launches, {p['kernel_events']} traced)")
                  if p["whole"] else
                  f"not measured (the window kept {p['kernel_events']} of "
                  f"{p['launches']} launches)" for p in prof)
              + f"; forward launches in the replicas over (a) and (b) "
              f"{b_launches}", flush=True)
        short = {k: w["short"] for k, w in windows.items() if w["short"]}
        if short:
            raise SystemExit(f"serve (b): requests streamed short: {short}")
        if not all(all(n > 0 for n in w["per_replica"])
                   for w in windows.values()):
            raise SystemExit("serve (b): a replica served no request")
        if not all(n > 0 for n in b_launches):
            raise SystemExit(f"serve (b): a replica never launched the "
                             f"forward kernel: {b_launches}")

        # (c) a replica dies under kill-rung traffic, the KV tier on
        kill_reqs = sb._build_requests(SERVE_KILL["requests"],
                                       SERVE_BENCH_SEED,
                                       families=SERVE_KILL["families"])
        kill_at = int(SERVE_KILL["requests"] * SERVE_KILL["kill_frac"])
        page = serve_llm_config().engine_config.page_size
        kill_roots = {PrefixCache.root_digest_for(prompt, page)
                      for _, prompt in kill_reqs}
        stats0 = {r.actor_id: call(r, replica_engine_stats) for r in reps}
        done, errors, lock = [0], [], threading.Lock()
        killed = {}

        def one(i):
            _, prompt = kill_reqs[i]
            try:
                out = ingress.handle_http.remote({
                    "path": "/v1/completions", "body": {
                        "prompt": prompt, "max_tokens": 1,
                        "ignore_eos": True}}).result(
                            timeout_s=SERVE_TIMEOUT_S)
                if out["usage"]["completion_tokens"] != 1:
                    raise RuntimeError(f"short: {out}")
            except Exception as e:  # noqa: BLE001 — counted, then gated
                with lock:
                    errors.append(repr(e))
                return
            with lock:
                done[0] += 1
                fire = done[0] == kill_at
            if fire:
                # the replica holding the most of the burst's families (its
                # engine's hottest family rows; the busier one on a tie)
                st = {r.actor_id: call(r, replica_engine_stats)
                      for r in reps}
                held = {rid: sum(row["root"] in kill_roots
                                 for row in s_["kv_families"])
                        for rid, s_ in st.items()}
                victim = max(reps, key=lambda r: (
                    held[r.actor_id], st[r.actor_id]["replica_total"]))
                killed.update(
                    replica=victim, pid=call(victim, replica_identity)["pid"],
                    launches=call(victim, replica_launches),
                    survivor_stats=next(st[r.actor_id] for r in reps
                                        if r is not victim),
                    families=[held[r.actor_id] for r in reps])
                killed["t"] = time.monotonic()
                rt.kill(victim)

        t0 = time.monotonic()
        with ThreadPoolExecutor(SERVE_KILL["concurrency"]) as pool:
            list(pool.map(one, range(SERVE_KILL["requests"])))
        burst_s = time.monotonic() - t0
        if "replica" not in killed:
            raise SystemExit(f"serve (c): the kill never fired ({done[0]} "
                             f"done, errors {errors[:3]})")
        victim = killed["replica"]
        survivor = next(r for r in reps if r is not victim)
        deadline = time.monotonic() + SERVE_START_S
        while True:
            info = replicas(SERVE_APP, server_dep)
            fresh = [r for r in info["replicas"]
                     if r.actor_id not in (victim.actor_id,
                                           survivor.actor_id)]
            if fresh and len(info["replicas"]) == 2:
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"serve (c): no replacement replica: "
                                 f"{info}")
            time.sleep(0.2)
        recovery_s = time.monotonic() - killed["t"]
        dead_reported = victim.actor_id in info.get("dead", [])
        replacement = fresh[0]
        (rep_ident,) = on_card([replacement], "(c) the replacement")
        exit_deadline = time.monotonic() + 60
        while not pid_exited(killed["pid"]):
            if time.monotonic() > exit_deadline:
                raise SystemExit(f"serve (c): the killed replica's process "
                                 f"{killed['pid']} did not exit")
            time.sleep(0.2)
        # the replacement's warm restart pulls asynchronously
        pull_deadline = time.monotonic() + 30
        while True:
            s_surv = call(survivor, replica_engine_stats)
            s_new = call(replacement, replica_engine_stats)
            surv_pulls = s_surv["kv_pulls"] - stats0[
                survivor.actor_id]["kv_pulls"]
            if surv_pulls + s_new["kv_pulls"] > 0 or \
                    time.monotonic() > pull_deadline:
                break
            time.sleep(0.5)
        at_kill = killed["survivor_stats"]["prefix_cache"]

        def prefilled(pc):
            return pc["lookup_tokens"] - pc["hit_tokens"]

        extra = (prefilled(s_surv["prefix_cache"]) - prefilled(at_kill)
                 + prefilled(s_new["prefix_cache"]))
        c_launches = [killed["launches"],
                      call(survivor, replica_launches, True),
                      call(replacement, replica_launches, True)]
        launches["c"] = sum(c_launches)
        res["c"] = {"requests": SERVE_KILL["requests"], "completed": done[0],
                    "errors": errors, "burst_s": burst_s,
                    "kill_after": kill_at, "families": killed["families"],
                    "recovery_s": recovery_s, "dead_reported": dead_reported,
                    "killed_pid": killed["pid"], "replacement": rep_ident,
                    "survivor_pulls": surv_pulls,
                    "replacement_pulls": s_new["kv_pulls"],
                    "replacement_pull_fallbacks": s_new["kv_pull_fallbacks"],
                    "extra_prefill_tokens": extra,
                    "launches_victim_survivor_replacement": c_launches}
        print(f"serve (c): {done[0]}/{SERVE_KILL['requests']} completed, "
              f"{len(errors)} errors, in {burst_s:.2f} s; killed replica "
              f"pid {killed['pid']} after {kill_at} (the burst's families "
              f"held by each replica {killed['families']}); the controller reported the death: "
              f"{dead_reported}; replacement pid {rep_ident['pid']} on the "
              f"card ({rep_ident['gauge_in_use']:.0f} device bytes) "
              f"{recovery_s:.2f} s after the kill; the killed process "
              f"exited; store-tier pulls: survivor +{surv_pulls}, "
              f"replacement {s_new['kv_pulls']}; extra prefill tokens after "
              f"the kill {extra}; forward launches (victim, survivor, "
              f"replacement) {c_launches}", flush=True)
        if errors or done[0] != SERVE_KILL["requests"]:
            raise SystemExit(f"serve (c): requests failed: {errors[:3]}")
        if not dead_reported:
            raise SystemExit("serve (c): the controller did not report the "
                             "death")
        if surv_pulls + s_new["kv_pulls"] <= 0:
            raise SystemExit("serve (c): no store-tier pull on the survivor "
                             "or the replacement")
        serve.delete(SERVE_APP)

        # (d) prefill and decode replicas, the handoff through the tier;
        # the first prompt warms both replicas and is not timed
        texts = [frontend_prompt(40 + i, 300) for i in range(4)]
        t0 = time.monotonic()
        serve.run(build_pd_openai_app(serve_llm_config(
            replicas=1, default_max_tokens=PD_MAX_TOKENS)), name="pd",
            route_prefix="/pd", _blocking_timeout_s=SERVE_START_S)
        pd_running_s = time.monotonic() - t0
        (p_rep,) = replicas("pd", f"Prefill:{SERVE_MODEL_ID}")["replicas"]
        (d_rep,) = replicas("pd", f"Decode:{SERVE_MODEL_ID}")["replicas"]
        pd_ident = on_card([p_rep, d_rep], "(d)")
        for r in (p_rep, d_rep):
            call(r, replica_launches, True)
        prefill = serve.DeploymentHandle("pd", f"Prefill:{SERVE_MODEL_ID}")
        decode = serve.DeploymentHandle("pd", f"Decode:{SERVE_MODEL_ID}")
        params = {"max_tokens": PD_MAX_TOKENS}
        pd_ids, handoffs, pd_ms = [], [], []
        for text in texts:
            t1 = time.perf_counter()
            pre = prefill.prefill.remote(text, params).result(
                timeout_s=SERVE_TIMEOUT_S)
            t2 = time.perf_counter()
            out = decode.decode.remote(pre, params).result(
                timeout_s=SERVE_TIMEOUT_S)
            t3 = time.perf_counter()
            pd_ids.append(out["tokens"])
            handoffs.append(bool(pre.get("kv_in_tier"))
                            and "kv_k" not in pre)
            pd_ms.append(((t2 - t1) * 1e3, (t3 - t2) * 1e3))
        # one more prompt through the ingress (PDRouter), which makes the
        # same two calls; a prompt of its own, so that the three above keep
        # the spines they were handed off with for the reference below
        via_pd = serve.get_app_handle("pd").handle_http.remote({
            "path": "/v1/completions", "body": {
                "prompt": frontend_prompt(44, 300),
                "max_tokens": PD_MAX_TOKENS}}).result(
                    timeout_s=SERVE_TIMEOUT_S)
        d_stats = call(d_rep, replica_engine_stats)
        d_launches = [call(r, replica_launches, True) for r in (p_rep, d_rep)]
        launches["d"] = sum(d_launches)
        serve.delete("pd")
        # the reference, in a task of its own holding the card (this
        # process launches no kernel from another thread in this phase)
        ref = rt.get(rt.remote(num_gpus=0.5)(pd_reference).remote(texts),
                     timeout=SERVE_TIMEOUT_S)
        card_pids.add(ref["pid"])
        pull_ms = (d_stats.get("kv_tier") or {}).get("last_pull_ms")
        res["d"] = {"running_s": pd_running_s, "replicas": pd_ident,
                    "ids": pd_ids, "ids_equal": pd_ids == ref["tier"],
                    "reference_pulls": ref["tier_pulls"],
                    "cold_ids_equal": [a == b for a, b
                                       in zip(pd_ids, ref["cold"])],
                    "kv_in_tier": handoffs,
                    "decode_kv_pulls": d_stats["kv_pulls"],
                    "decode_kv_pull_pages": d_stats["kv_pull_pages"],
                    "decode_pull_fallbacks": d_stats["kv_pull_fallbacks"],
                    "prefill_decode_ms": pd_ms, "last_pull_ms": pull_ms,
                    "ingress_usage": via_pd["usage"],
                    "launches_prefill_decode": d_launches}
        print(f"serve (d): build_pd_openai_app RUNNING in "
              f"{pd_running_s:.1f} s (prefill pid {pd_ident[0]['pid']}, "
              f"decode pid {pd_ident[1]['pid']}); handoffs through the store "
              f"tier {handoffs}; the decode replica pulled "
              f"{d_stats['kv_pulls']} spines ({d_stats['kv_pull_pages']} "
              f"pages, {d_stats['kv_pull_fallbacks']} fallbacks), its last "
              f"pull {pull_ms} ms; prefill / decode call ms "
              + ", ".join(f"{a:.1f} / {b:.1f}" for a, b in pd_ms[1:])
              + f" (the warm-up's {pd_ms[0][0]:.1f} / {pd_ms[0][1]:.1f})"
              + f"; ids equal to a single engine pulling the same spines "
              f"({ref['tier_pulls']} pulls): {pd_ids == ref['tier']}; equal "
              f"to a cold single engine's: {res['d']['cold_ids_equal']}; "
              f"through the ingress: {via_pd['usage']}; forward launches "
              f"(prefill, decode) {d_launches}", flush=True)
        if not (pd_ids == ref["tier"] and all(handoffs)
                and ref["tier_pulls"] >= len(texts)
                and d_stats["kv_pulls"] >= len(texts)
                and d_stats["kv_pull_fallbacks"] == 0
                and via_pd["usage"]["completion_tokens"] >= 1
                and all(len(i) >= 1 for i in pd_ids)):
            raise SystemExit(f"serve (d): the P/D handoff failed: "
                             f"{res['d']}")
        if d_launches[0] <= 0:
            raise SystemExit("serve (d): the prefill replica never launched "
                             "the forward kernel")
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    # the phase ends when every process that held the card has exited
    res["exit_wait_s"] = wait_exited(card_pids, "serve")
    res["launches"] = launches
    res["phase_s"] = time.monotonic() - t_phase
    report["serve"] = res
    total = sum(launches.values())
    print(f"serve: forward launches in the replicas' processes {launches} "
          f"= {total}; the {len(card_pids)} processes that held the card "
          f"exited {res['exit_wait_s']:.2f} s after the shutdown; session "
          f"{node.session_dir}; phase "
          f"{res['phase_s']:.1f} s", flush=True)
    return total


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

    # where one step's device time goes (outside the counted run); a
    # window that lost one of the step's kernel events is profiled again
    want_profiled = {**{k: cfg.n_layers for k in BF16_KERNELS.values()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    rows = device_events(lambda: step(state, tokens),
                         complete=profiled_as(want_profiled))
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
    consumed (all of them, and each batch's), the pid of the split
    coordinator feeding its shard, the group's ``MASTER_ADDR`` and
    ``MASTER_PORT`` as the rank saw them, and the worker's kernel launches
    over the loop (its counters are its own process's)."""
    import hashlib

    import torch

    import ray_tpu_torch as rt
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
    # the process feeding this worker's shard: a streaming_split coordinator
    coord = getattr(getattr(train.get_dataset_shard("train"), "_bundles",
                            None), "_coord", None)
    coord_pid = (rt.get(coord.__rtpu_apply__.remote(process_cuda),
                        timeout=60)[0] if coord is not None else None)
    train.report({
        "batch_sha256": [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                         for t in kept],
        "coordinator_pid": coord_pid,
        "losses": [float(x) for x in losses], "wait_ms": waits,
        "step_ms": step_ms,
        "tokens_per_s": config["batch"] * (rows.shape[1] - 1)
        / (step_ms / 1e3),
        "hidden_share": sum(hidden) / len(hidden), "hidden": hidden,
        "rows": rows.shape[0], "exhausted": exhausted,
        "rows_sha256": hashlib.sha256(rows.tobytes()).hexdigest(),
        "launches": launches, "device": torch.cuda.get_device_name(device),
        "master": {k: os.environ.get(k)
                   for k in ("MASTER_ADDR", "MASTER_PORT")},
        "pid": os.getpid()})


def h2d_gbps(nbytes: int, pinned: bool, iters: int) -> float:
    """Host-to-device GB/s of one ``nbytes`` copy from pinned or pageable
    host memory (CUDA events around ``iters`` copies)."""
    import torch

    src = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pinned)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: dst.copy_(src, non_blocking=pinned), iters)
    return nbytes / (ms / 1e3) / 1e9


def run_torch_trainer(report):
    """The user's loop on the card: ``TorchTrainer`` at one GPU worker, an
    actor of the port's runtime in a ``{"CPU": 1, "GPU": 1}`` bundle
    (NCCL at world size 1), over ``from_numpy`` token rows (one block in
    the store, dealt by ``streaming_split``'s coordinator actor), read
    through ``iter_torch_batches`` onto the card into ``run_trainer``'s
    GPT-2 124M
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

    import ray_tpu_torch as rt
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
    node = card_runtime()
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
        rt.shutdown()
    fit_s = time.monotonic() - t0
    if result.error is not None:
        kept = keep_session_logs(node, "torch_trainer")
        raise SystemExit(f"the TorchTrainer loop failed: {result.error} "
                         f"(the session's logs in {kept})")
    m = result.metrics
    if m["pid"] == os.getpid():
        raise SystemExit("the TorchTrainer loop ran in this process")
    exit_wait_s = wait_exited([m["pid"]], "torch trainer")
    from ray_tpu_torch.train.worker_group import _default_master_addr

    default_addr = _default_master_addr()
    print(f"torch trainer group: the rank saw MASTER_ADDR="
          f"{m['master']['MASTER_ADDR']} MASTER_PORT="
          f"{m['master']['MASTER_PORT']} (TorchConfig's default address "
          f"on this host: {default_addr})", flush=True)
    if m["master"]["MASTER_ADDR"] != default_addr \
            or not int(m["master"]["MASTER_PORT"] or 0) > 0:
        raise SystemExit(f"the group formed at {m['master']}, not at "
                         f"TorchConfig's default address {default_addr}")

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
          f"worker actor (pid {m['pid']}, exited {exit_wait_s:.2f} s after "
          f"the runtime's shutdown), {n_steps} steps of GPT-2 124M over "
          f"iter_torch_batches ({fit_s:.1f} s for fit): loss first "
          f"{losses[0]:.6f} last "
          f"{losses[-1]:.6f}; this process's own first step "
          f"{own_loss:.6f} (diff {abs(losses[0] - own_loss):.3e}, tol "
          f"{STEP_LOSS_TOL:.0e}); {m['step_ms']:.3f} ms a timed step, "
          f"{m['tokens_per_s']:.1f} tokens/s = {ratio:.4f} of run_trainer's "
          f"{report['trainer']['tokens_per_s']:.1f} (PR 15's run 8, before "
          f"the split coordinator: 0.9995); next(batch) wait p50 "
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
        m, fit_s=fit_s, exit_wait_s=exit_wait_s, own_first_loss=own_loss,
        tokens_per_s_ratio=ratio,
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


# Tune on the card (``run_tune``): GPT-2 124M trials, each training in its
# own process through the kernels on rows of ids below TUNE_IDS (the loss
# can fall from ~10.9 toward ln 512 within tens of steps, so the learning
# rate decides the ranking), the rows of step i the i-th BATCH rows of
# default_rng(TUNE_SEED).  (a) ASHA over 4 learning rates, two trials at
# a time, each at half the card: the rates run from the strongest down,
# so the weak trials reach each rung after its history holds the strong
# ones' (the first arrival at a rung always continues).  (b) a trainer
# inside a trial, its worker killed once at step TUNE_KILL_AT (12 steps,
# killed at 6, for the script's time since the autoscaler's phase came;
# it was 16 and 10).  (c) PBT at
# GPT-2's width cut to TUNE_PBT_LAYERS layers and TUNE_PBT_STEPS steps, for
# the script's time (its 1200 s limit): the weak trial can exploit at steps
# 4 and 8.
TUNE_SEED = 23
TUNE_IDS = 512
TUNE_ASHA_LRS = [6e-4, 1e-4, 1e-5, 1e-6]
TUNE_ASHA = {"max_t": 24, "grace_period": 6, "reduction_factor": 2}
TUNE_TRAINER_STEPS, TUNE_CKPT_EVERY, TUNE_KILL_AT = 12, 4, 6
TUNE_PBT_LAYERS, TUNE_PBT_STEPS, TUNE_PBT_INTERVAL = 2, 12, 4
TUNE_PBT_LRS = [1e-6, 6e-4]
TUNE_START_S = 120  # a trial's wait for its peer at the start barrier


def tune_rows(step: int):
    """The token rows of step ``step`` (every trial's, every attempt's)."""
    import numpy as np

    rows = np.random.default_rng(TUNE_SEED).integers(
        0, TUNE_IDS, ((step + 1) * BATCH, SEQ + 1))
    return rows[step * BATCH:]


def tune_gpt2_state(cfg, lr, device):
    """run_trainer's GPT-2 step and a fresh state from TUNE_SEED (every
    trial and this process start from the same parameters)."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step

    opt = train_step.default_optimizer(learning_rate=lr, warmup_steps=1)
    gen = torch.Generator(device=device).manual_seed(TUNE_SEED)
    state = train_step.create_train_state(gpt2, cfg, opt, gen, device=device)
    return state, train_step.make_train_step(gpt2, cfg, opt,
                                             attn_impl="flash")


def tune_step_record(step, state, i, device, start):
    """One step on rows ``i``; its loss (computed before the update), its
    launches in this process, and where it ran."""
    import torch

    before = launch_counts()
    state, m = step(state, torch.from_numpy(tune_rows(i)).to(device))
    loss = m["loss"].item()  # waits for the step
    return state, {
        "step": i, "loss": loss, "t": time.time(),
        "launches": {k: n - before[k] for k, n in launch_counts().items()},
        "pid": os.getpid(), "device": f"cuda:{torch.cuda.current_device()}",
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "restored_from": start}


def tune_gpt2_trainable(config):
    """(a) and (c)'s trial: GPT-2 at ``config["cfg"]`` on the card its
    grant leaves visible, from TUNE_SEED's parameters or the checkpoint
    Tune hands it (PBT's exploit), ``config["steps"]`` steps, each
    reported (``training_iteration`` is the step's index + 1) and logged
    to ``steps.jsonl`` in the trial's directory; a checkpoint every
    ``config["ckpt_every"]`` steps.  Trials with ``config["barrier"]``
    wait there until two have started: the first two start their steps
    together."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch import tune
    from ray_tpu_torch.train.checkpoint import (
        Checkpoint, load_pytree, save_pytree)
    from ray_tpu_torch.tune import trial as trial_mod

    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    state, step = tune_gpt2_state(config["cfg"], config["lr"], device)
    start, ckpt = 0, tune.get_checkpoint()
    if ckpt is not None:
        state = load_pytree(ckpt.path, state)
        start = int(state["step"])
    elif config.get("barrier"):
        open(os.path.join(config["barrier"], str(os.getpid())), "w").close()
        deadline = time.time() + TUNE_START_S
        while len(os.listdir(config["barrier"])) < 2:
            if time.time() > deadline:
                raise RuntimeError("the other trial did not start")
            time.sleep(0.05)
    log = os.path.join(trial_mod.get_session().trial_dir, "steps.jsonl")
    for i in range(start, config["steps"]):
        state, rec = tune_step_record(step, state, i, device, start)
        rec.update(lr=config["lr"], t_enter=t_enter)
        with open(log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        d = None
        if config.get("ckpt_every") and (i + 1) % config["ckpt_every"] == 0:
            d = tempfile.mkdtemp(dir=config["tmp"])
            save_pytree(d, state)
        try:
            tune.report({"loss": rec["loss"], "training_iteration": i + 1},
                        checkpoint=Checkpoint(d) if d else None)
        finally:
            if d:
                shutil.rmtree(d)


def tune_trainer_loop(config):
    """(b)'s train function, in the trainer's worker actor: the GPT-2 124M
    step from TUNE_SEED's parameters or the latest committed checkpoint,
    ``config["steps"]`` steps, each reported and logged to
    ``steps.jsonl`` in the experiment's directory (a report the process's
    death loses stays in the log), a checkpoint every
    ``config["ckpt_every"]``; on the first attempt its process exits at
    step ``config["kill_at"]``, once the controller has polled every
    report before it (the marker file makes sure of once)."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train.checkpoint import load_pytree, save_pytree

    t_enter = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    device = torch.device(ctx.get_device())
    state, step = tune_gpt2_state(config["cfg"], config["lr"], device)
    start, ckpt, restore_s = 0, train.get_checkpoint(), None
    if ckpt is not None:
        t0 = time.perf_counter()
        state = load_pytree(ckpt.path, state)
        restore_s = time.perf_counter() - t0
        start = int(state["step"])
    for i in range(start, config["steps"]):
        if i == config["kill_at"] and not os.path.exists(config["marker"]):
            while not ctx.outbox.empty():
                time.sleep(0.01)
            open(config["marker"], "w").close()
            os._exit(1)  # the worker's process dies mid-run
        state, rec = tune_step_record(step, state, i, device, start)
        rec.update(t_enter=t_enter, restore_s=restore_s,
                   device_name=ctx.get_device())
        ckpt = None
        if (i + 1) % config["ckpt_every"] == 0:
            d = os.path.join(ctx.experiment_dir, f"ckpt-{i + 1:06d}")
            t0 = time.perf_counter()
            rec["save_bytes"] = save_pytree(d, state)
            rec["save_s"] = time.perf_counter() - t0
            ckpt = train.Checkpoint(d)
        with open(os.path.join(ctx.experiment_dir, "steps.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        train.report(rec, checkpoint=ckpt)


def tune_trainer_trainable(config):
    """(b)'s trial: ``TorchTrainer`` at one GPU worker, whose callback
    passes each committed report to ``tune.report``; the trial reports
    the committed records' steps, the trainer's result, and whether this
    process ever created a CUDA context, last."""
    import torch

    from ray_tpu_torch import train, tune

    seen = []

    def on_report(index, metrics, checkpoint):
        seen.append((index, metrics["step"]))
        tune.report({"loss": metrics["loss"],
                     "training_iteration": metrics["step"] + 1})

    result = train.TorchTrainer(
        tune_trainer_loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
        run_config=train.RunConfig(
            name="trainer", storage_path=config["tmp"],
            failure_config=train.FailureConfig(max_failures=1)),
        callbacks=[on_report]).fit()
    tune.report({"committed": seen, "pid": os.getpid(),
                 "error": None if result.error is None else str(result.error),
                 "checkpoint": (result.checkpoint.path if result.checkpoint
                                else None),
                 "cuda_initialized": torch.cuda.is_initialized()})


def tune_log(path: str) -> list:
    """The step records logged to ``steps.jsonl`` under ``path``."""
    with open(os.path.join(path, "steps.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_tune(report):
    """Tune on the card (phase 10b, after ``run_torch_trainer``): trials
    are actors of the port's runtime, each training GPT-2 in its own
    process through the kernels.  (a) ``ASHAScheduler(max_t=24,
    grace_period=6, reduction_factor=2)`` over 4 learning rates,
    ``resources_per_trial={"num_cpus": 1, "num_gpus": 0.5}``, 2 at a
    time: all end without an error, one at least stops at a rung before
    24, every first loss equals this process's own first step on the same
    parameters and rows, 1e-6 ranks last, the best's loss falls, 12
    launches of each kernel a step in each trial's process, each on
    ``cuda:0`` with ``CUDA_VISIBLE_DEVICES`` 0; each trial's start-up,
    steps and stop, and the concurrent pair's tokens/s against
    ``run_trainer``'s.  (b) one trial (1 CPU, no GPU) running
    ``TorchTrainer`` at one GPU worker with ``FailureConfig(max_failures=
    1)``, a checkpoint every 4 of 12 steps, the worker's process exiting
    at step 6 once: 12 steps, the second attempt from the step-4
    checkpoint, its first loss equal to the first attempt's at that step,
    the killed process gone, no CUDA context in the trial's process, 12
    launches a step in the worker; seconds to a new worker, checkpoint
    save GB/s, steps lost.  (c) ``PopulationBasedTraining(
    perturbation_interval=4)`` over 2 trials at 2 layers, 12 steps, a
    checkpoint at each interval: the weak trial exploits, and its first
    loss after the restore equals the donor's at that step.  Every process
    that held the card has exited when the phase ends.  Returns the
    kernels' launches in the trials' and the worker's processes."""
    import dataclasses
    import shutil

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import RunConfig

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)  # run_trainer's
    t_phase = time.monotonic()
    tmp = checkpoint_dir(16 << 30, "tune")
    res, card_pids = {}, set()
    launches = {k: 0 for k in BF16_KERNELS}
    want_step = {k: cfg.n_layers for k in BF16_KERNELS}

    def add_launches(recs):
        for rec in recs:
            for k, n in rec["launches"].items():
                launches[k] += n
            card_pids.add(rec["pid"])

    # this process's own first step on the trials' parameters and rows
    state, step = tune_gpt2_state(cfg, TUNE_ASHA_LRS[0], "cuda")
    _, own = tune_step_record(step, state, 0, "cuda", 0)
    del state, step
    torch.cuda.empty_cache()

    node = card_runtime()
    try:
        # (a) ASHA over function trials on the card
        t0 = time.time()
        os.makedirs(os.path.join(tmp, "asha_barrier"))
        grid = tune.Tuner(
            tune_gpt2_trainable,
            param_space={"lr": tune.grid_search(TUNE_ASHA_LRS), "cfg": cfg,
                         "steps": TUNE_ASHA["max_t"],
                         "barrier": os.path.join(tmp, "asha_barrier")},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.ASHAScheduler(**TUNE_ASHA),
                max_concurrent_trials=2,
                resources_per_trial={"num_cpus": 1, "num_gpus": 0.5}),
            run_config=RunConfig(name="asha", storage_path=tmp)).fit()
        fit_s = time.time() - t0
        if grid.errors:
            raise SystemExit(f"tune (a): trials failed: {grid.errors}")
        trials = []
        for r in grid:
            recs = tune_log(r.path)
            add_launches(recs)
            # a trial ASHA stops runs on until the stop reaches it: its
            # log may hold a step or two past the rung
            trials.append({
                "lr": r.config["lr"], "steps": len(recs),
                "stop_iteration": recs[-1]["step"] + 1,
                "first_loss": recs[0]["loss"], "last_loss": recs[-1]["loss"],
                "best_loss": r.metrics["loss"],  # the tuner's best result
                "enter_after_fit_s": recs[0]["t_enter"] - t0,
                "to_first_step_s": recs[0]["t"] - recs[0]["t_enter"],
                "pid": recs[0]["pid"],
                "devices": sorted({(r["device"], r["visible"])
                                   for r in recs}),
                "launches_ok": all(r["launches"] == want_step
                                   for r in recs)})
        # the concurrent pair (the first two launched, which start their
        # steps together): tokens of both trials' steps that ended inside
        # the window both were stepping
        pair = [tune_log(r.path) for r in grid][:2]
        w0 = max(recs[0]["t"] for recs in pair)
        w1 = min(recs[-1]["t"] for recs in pair)
        if w1 <= w0:
            raise SystemExit("tune (a): the first two trials never stepped "
                             "at the same time")
        n_steps = sum(w0 < r["t"] <= w1 for recs in pair for r in recs)
        pair_tok_s = n_steps * BATCH * SEQ / (w1 - w0)
        ranked = sorted(trials, key=lambda t: t["best_loss"])
        best = ranked[0]
        d_first = max(abs(t["first_loss"] - own["loss"]) for t in trials)
        res["a"] = {"trials": trials, "fit_s": fit_s,
                    "own_first_loss": own["loss"],
                    "first_loss_max_diff": d_first,
                    "concurrent_tokens_per_s": pair_tok_s,
                    "concurrent_window_s": w1 - w0,
                    "concurrent_steps": n_steps,
                    "ranking": [t["lr"] for t in ranked],
                    "best": grid.get_best_result().config["lr"]}
        ratio = pair_tok_s / report["trainer"]["tokens_per_s"]
        print(f"tune (a): ASHA over GPT-2 124M trials ({fit_s:.1f} s for "
              f"fit): " + "; ".join(
                  f"lr {t['lr']:g}: {t['steps']} steps, stopped at "
                  f"{t['stop_iteration']}, loss {t['first_loss']:.4f} -> "
                  f"{t['last_loss']:.4f}, entered {t['enter_after_fit_s']:.1f}"
                  f" s after fit began, {t['to_first_step_s']:.1f} s to its "
                  f"first step, pid {t['pid']} on {t['devices']}"
                  for t in trials)
              + f"; this process's first loss {own['loss']:.6f} (max diff "
              f"{d_first:.3e}, tol {STEP_LOSS_TOL:.0e}); ranking by best "
              f"loss {res['a']['ranking']}; the concurrent pair "
              f"{pair_tok_s:.1f} tokens/s over {w1 - w0:.2f} s = "
              f"{ratio:.4f} of run_trainer's "
              f"{report['trainer']['tokens_per_s']:.1f}", flush=True)
        if not (len(trials) == 4 and all(
                t["stop_iteration"] <= TUNE_ASHA["max_t"] for t in trials)):
            raise SystemExit(f"tune (a): not every trial ended: {trials}")
        if not any(t["stop_iteration"] < TUNE_ASHA["max_t"] for t in trials):
            raise SystemExit("tune (a): no trial stopped at a rung")
        if d_first > STEP_LOSS_TOL:
            raise SystemExit("tune (a): a trial's first loss disagrees with "
                             "this process's step on the same parameters")
        if ranked[-1]["lr"] != 1e-6:
            raise SystemExit(f"tune (a): lr 1e-6 does not rank last: "
                             f"{res['a']['ranking']}")
        if not best["last_loss"] < best["first_loss"]:
            raise SystemExit("tune (a): the best trial's loss did not fall")
        if not all(t["launches_ok"] for t in trials):
            raise SystemExit(f"tune (a): a trial's step did not launch each "
                             f"kernel {cfg.n_layers} times")
        if not all(t["devices"] == [("cuda:0", "0")] for t in trials):
            raise SystemExit("tune (a): a trial did not run on cuda:0 under "
                             "its grant's CUDA_VISIBLE_DEVICES")

        # (b) a trainer inside a trial, through its worker's death
        marker = os.path.join(tmp, "killed")
        grid = tune.Tuner(
            tune_trainer_trainable,
            param_space={"cfg": cfg, "lr": 6e-4, "tmp": tmp, "marker": marker,
                         "steps": TUNE_TRAINER_STEPS,
                         "ckpt_every": TUNE_CKPT_EVERY,
                         "kill_at": TUNE_KILL_AT},
            tune_config=tune.TuneConfig(resources_per_trial={"num_cpus": 1}),
            run_config=RunConfig(name="trainer_trial", storage_path=tmp)).fit()
        if grid.errors:
            raise SystemExit(f"tune (b): the trial failed: {grid.errors}")
        out = grid[0].metrics
        recs = tune_log(os.path.join(tmp, "trainer"))
        add_launches(recs)
        first = [r for r in recs if r["restored_from"] == 0]
        second = [r for r in recs if r["restored_from"] > 0]
        killed_pid = first[0]["pid"]
        card_pids.add(killed_pid)
        at = {r["step"]: r["loss"] for r in first}
        restored = second[0]["restored_from"] if second else None
        saves = [r for r in recs if r.get("save_s")]
        gbps = [r["save_bytes"] / r["save_s"] / 1e9 for r in saves]
        to_new_s = second[0]["t_enter"] - os.path.getmtime(marker)
        d_restore = (abs(second[0]["loss"] - at[restored])
                     if restored in at else None)
        res["b"] = {"error": out["error"],
                    "steps": sorted({r["step"] for r in recs}),
                    "committed": out["committed"],
                    "restored_from": restored, "killed_pid": killed_pid,
                    "killed_gone": pid_exited(killed_pid),
                    "worker_pids": sorted({r["pid"] for r in recs}),
                    "trial_pid": out["pid"],
                    "trial_cuda_initialized": out["cuda_initialized"],
                    "seconds_to_new_worker": to_new_s,
                    "restore_s": second[0]["restore_s"] if second else None,
                    "save_gbps": gbps, "save_bytes": saves[0]["save_bytes"],
                    "steps_lost": TUNE_KILL_AT - (restored or 0),
                    "restore_loss_diff": d_restore,
                    "devices": sorted({(r["device_name"], r["visible"])
                                       for r in recs}),
                    "launches_ok": all(r["launches"] == want_step
                                       for r in recs)}
        print(f"tune (b): TorchTrainer in a trial (pid {out['pid']}, CUDA "
              f"context there: {out['cuda_initialized']}), its worker "
              f"(pid {killed_pid}) exiting at step {TUNE_KILL_AT}: restored "
              f"from step {restored} in a new worker (pids "
              f"{res['b']['worker_pids']}) {to_new_s:.2f} s after the death "
              f"(restore {res['b']['restore_s']} s); first loss after the "
              f"restore {second[0]['loss'] if second else None} vs "
              f"{at.get(restored)} (diff {d_restore}); checkpoints of "
              f"{saves[0]['save_bytes'] / 1e9:.3f} GB saved at "
              + ", ".join(f"{g:.3f}" for g in gbps)
              + f" GB/s; steps lost {res['b']['steps_lost']}; steps "
              f"logged {len(recs)}, committed (index, step) "
              f"{out['committed']}; the killed process gone: "
              f"{res['b']['killed_gone']}", flush=True)
        if (out["error"] is not None
                or res["b"]["steps"] != list(range(TUNE_TRAINER_STEPS))
                or out["committed"][-1][1] != TUNE_TRAINER_STEPS - 1):
            raise SystemExit(f"tune (b): the trainer did not end with "
                             f"{TUNE_TRAINER_STEPS} steps: {res['b']}")
        last_ckpt = TUNE_KILL_AT // TUNE_CKPT_EVERY * TUNE_CKPT_EVERY
        if restored != last_ckpt:
            raise SystemExit(f"tune (b): the second attempt started from "
                             f"step {restored}, not the step-{last_ckpt} "
                             f"checkpoint")
        if d_restore is None or d_restore > STEP_LOSS_TOL:
            raise SystemExit("tune (b): the first loss after the restore "
                             "disagrees with the first attempt's")
        if not res["b"]["killed_gone"]:
            raise SystemExit("tune (b): the killed worker's process lives")
        if out["cuda_initialized"]:
            raise SystemExit("tune (b): the trial's process created a CUDA "
                             "context")
        if not (res["b"]["launches_ok"]
                and res["b"]["devices"] == [("cuda:0", "0")]):
            raise SystemExit(f"tune (b): the worker did not launch each "
                             f"kernel {cfg.n_layers} times a step on cuda:0")

        # (c) PBT across processes, at TUNE_PBT_LAYERS layers
        pbt_cfg = dataclasses.replace(cfg, n_layers=TUNE_PBT_LAYERS)
        barrier = os.path.join(tmp, "pbt_barrier")
        os.makedirs(barrier)
        grid = tune.Tuner(
            tune_gpt2_trainable,
            param_space={"lr": tune.grid_search(TUNE_PBT_LRS), "cfg": pbt_cfg,
                         "steps": TUNE_PBT_STEPS,
                         "ckpt_every": TUNE_PBT_INTERVAL, "tmp": tmp,
                         "barrier": barrier},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.PopulationBasedTraining(
                    perturbation_interval=TUNE_PBT_INTERVAL,
                    hyperparam_mutations={"lr": [3e-4, 6e-4, 1e-3]},
                    seed=TUNE_SEED),
                max_concurrent_trials=2,
                resources_per_trial={"num_cpus": 1, "num_gpus": 0.5}),
            run_config=RunConfig(name="pbt", storage_path=tmp)).fit()
        if grid.errors:
            raise SystemExit(f"tune (c): trials failed: {grid.errors}")
        logs = [tune_log(r.path) for r in grid]
        for recs in logs:
            add_launches(recs)
        weak, donor = (logs if logs[0][0]["lr"] == TUNE_PBT_LRS[0]
                       else logs[::-1])
        after = [r for r in weak if r["restored_from"] > 0]
        donor_at = {r["step"]: r["loss"] for r in donor
                    if r["restored_from"] == 0}
        s0 = after[0]["restored_from"] if after else None
        d_pbt = (abs(after[0]["loss"] - donor_at[s0])
                 if after and s0 in donor_at else None)
        res["c"] = {"layers": TUNE_PBT_LAYERS,
                    "exploits": len({r["pid"] for r in after}),
                    "restored_from": sorted({r["restored_from"]
                                             for r in after}),
                    "weak_lrs": sorted({r["lr"] for r in weak}),
                    "first_loss_after_restore": (after[0]["loss"] if after
                                                 else None),
                    "donor_loss_at_step": donor_at.get(s0),
                    "diff": d_pbt,
                    "pids": sorted({r["pid"] for recs in logs for r in recs})}
        print(f"tune (c): PBT over 2 GPT-2 trials at {TUNE_PBT_LAYERS} "
              f"layers: the weak trial (lr {TUNE_PBT_LRS[0]:g}) exploited "
              f"{res['c']['exploits']} time(s), restored from steps "
              f"{res['c']['restored_from']} with lrs {res['c']['weak_lrs']}; "
              f"its first loss after the restore "
              f"{res['c']['first_loss_after_restore']} vs the donor's "
              f"{res['c']['donor_loss_at_step']} at that step (diff "
              f"{d_pbt}); processes {res['c']['pids']}", flush=True)
        if not after:
            raise SystemExit("tune (c): the weak trial never exploited")
        if d_pbt is None or d_pbt > STEP_LOSS_TOL:
            raise SystemExit("tune (c): the weak trial's first loss after "
                             "the restore disagrees with the donor's")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    res["exit_wait_s"] = wait_exited(card_pids, "tune")
    res["launches"] = launches
    res["phase_s"] = time.monotonic() - t_phase
    report["tune"] = res
    print(f"tune: launches in the trials' and the worker's processes "
          f"{launches}; the {len(card_pids)} processes that held the card "
          f"exited {res['exit_wait_s']:.2f} s after the shutdown; session "
          f"{node.session_dir}; phase {res['phase_s']:.1f} s", flush=True)
    return launches


# The actor plane (``run_actor_plane``): run_trainer's GPT-2 124M in two
# GPU actors at num_gpus 0.5, (a) as two pipeline stages of a compiled DAG
# and (b) as two data-parallel ranks averaging gradients through
# util.collective.  Rows of ids from default_rng(ACTOR_PLANE_SEED).
ACTOR_PLANE_SEED = 29
ACTOR_PLANE_MICROBATCHES = 8
ACTOR_PLANE_SEQUENTIAL = 3  # one microbatch at a time: the handoff alone
ACTOR_PLANE_DP_STEPS = 3
ACTOR_PLANE_STORE_BYTES = 4 << 30  # (b) moves 2 x 497 MB a round
ACTOR_PLANE_TIMEOUT_S = 300


def plane_rows(i: int, vocab: int):
    """Microbatch or step ``i``'s token rows, (BATCH, SEQ + 1) int64."""
    import numpy as np

    rows = np.random.default_rng(ACTOR_PLANE_SEED).integers(
        0, vocab, ((i + 1) * BATCH, SEQ + 1))
    return rows[i * BATCH:]


def plane_forward(params, cfg, x, lo, hi, tokens=None):
    """GPT-2 blocks ``lo``..``hi`` - 1 through the port's ``gpt2._layer``
    and the flash kernels, without gradients.  ``x`` is the token rows
    (b, s + 1) when ``lo`` is 0 (the embeddings first), else the (b, s, d)
    activations.  A stage that ends the model applies the final norm and
    the tied head and returns each row's mean next-token loss (f32, (b,))
    and the last position's argmax ids against ``tokens`` (the rows); an
    earlier stage returns its activations."""
    import torch

    from ray_tpu_torch._device import torch_dtype
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.llama import layer_params
    from ray_tpu_torch.models.losses import head_logits
    from ray_tpu_torch.ops.attention import ATTENTION

    with torch.no_grad():
        if lo == 0:
            tokens = x
            s = tokens.shape[1] - 1
            x = (params["wte"][tokens[:, :-1]]
                 + params["wpe"][:s][None]).to(torch_dtype(cfg.dtype))
        for i in range(lo, hi):
            x = gpt2._layer(cfg, x, layer_params(params["layers"], i),
                            ATTENTION["flash"])
        if hi < cfg.n_layers:
            return x
        x = gpt2.layer_norm(x, params["lnf_g"], params["lnf_b"],
                            cfg.norm_eps)
        logits = head_logits(x, params["wte"].t())
        nll = (torch.logsumexp(logits, dim=-1)
               - logits.gather(-1, tokens[:, 1:, None])[..., 0])
        return nll.mean(dim=1), logits[:, -1].argmax(dim=-1)


def plane_state(device):
    """run_trainer's GPT-2 124M configuration and parameters from
    ACTOR_PLANE_SEED (every actor and this process alike)."""
    import torch

    from ray_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)
    gen = torch.Generator(device=device).manual_seed(ACTOR_PLANE_SEED)
    return cfg, gpt2.init(cfg, gen, device=device)


class PlaneActor:
    """One of ``run_actor_plane``'s GPU actors: the whole model from the
    seed, able to run any range of its blocks as a pipeline stage (a) or
    a data-parallel rank's step (b).  Every call records what it launched
    in this process."""

    def __init__(self, lo: int, hi: int):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.params = plane_state("cuda")
        self.lo, self.hi = lo, hi
        self.calls = []

    def forward(self, x, tokens=None, fail=False):
        """A pipeline stage: the first takes the rows, a later one the
        activations (a CPU view of the channel's slot, moved onto the card
        here before anything else)."""
        import torch

        t_in = time.time()
        if fail:
            raise ValueError("stage asked to fail on this microbatch")
        t0 = time.perf_counter()
        x = x.to("cuda")
        if tokens is not None:
            tokens = tokens.to("cuda")
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        before = launch_counts()
        out = plane_forward(self.params, self.cfg, x, self.lo, self.hi,
                            tokens)
        torch.cuda.synchronize()
        self.calls.append({
            "t_in": t_in, "t_out": time.time(), "h2d_s": h2d_s,
            "launches": {k: n - before[k]
                         for k, n in launch_counts().items()}})
        if self.hi < self.cfg.n_layers:
            return out  # a CUDA tensor: the channel copies it off the card
        return tuple(t.cpu() for t in out)

    def identity(self):
        import torch

        from ray_tpu_torch.dag import channel

        return {"pid": os.getpid(),
                "device": f"cuda:{torch.cuda.current_device()}",
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "writes": dict(channel.writes), "calls": self.calls}

    def dp_init(self, lr: float):
        from ray_tpu_torch.train import step as train_step

        self.opt = train_step.default_optimizer(learning_rate=lr,
                                                warmup_steps=1)
        self.opt_state = self.opt.init(self.params)

    def dp_step(self, rows, rank: int, world: int):
        """Rank ``rank``'s rows of ``rows``: GPT-2's gradients through the
        three kernels, flattened into one f32 tensor, summed over the
        ranks by ``allreduce``, divided by the world size, then the
        trainer's AdamW update.  Returns the rows' loss, the launches,
        the allreduce's seconds and a bit checksum of every leaf."""
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.train.step import tree_leaves
        from ray_tpu_torch.util import collective

        n = rows.shape[0] // world
        mine = torch.from_numpy(rows[rank * n:(rank + 1) * n]).to("cuda")
        leaves = tree_leaves(self.params)
        for t in leaves:
            t.requires_grad_(True)
        before = launch_counts()
        loss = gpt2.loss_fn(self.params, mine, self.cfg)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([g.reshape(-1) for g in grads])
        del grads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summed = collective.allreduce(flat, group_name="dp",
                                      timeout=ACTOR_PLANE_TIMEOUT_S)
        allreduce_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mean = summed.to("cuda") / world
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        out, at = [], 0
        for t in leaves:
            out.append(mean[at:at + t.numel()].view_as(t))
            at += t.numel()
        self.opt.update(self.params, out, self.opt_state)
        torch.cuda.synchronize()
        return {"loss": loss.item(), "allreduce_s": allreduce_s,
                "h2d_s": h2d_s, "bytes": flat.numel() * flat.element_size(),
                "dtype": str(summed.dtype), "device": summed.device.type,
                "launches": {k: n - before[k]
                             for k, n in launch_counts().items()},
                "checksums": [byte_checksum(t.detach()) for t in leaves]}


def run_actor_plane(report):
    """The actor plane on the card (after ``run_tune``): two GPU actors at
    ``num_gpus`` 0.5, each holding run_trainer's GPT-2 124M from one seed.
    (a) A compiled DAG ``InputNode -> stage 0 (blocks 0-5) -> stage 1
    (blocks 6-11, ln_f, head)``, one microbatch of 12 x 1024 tokens to
    warm the stages, then 8 submitted before any is read (timed): every
    microbatch's per-row losses equal
    this process's 12-layer forward within STEP_LOSS_TOL and its argmax
    ids equal, each stage launched the forward kernel 6 times a
    microbatch in its own process, an error raised in stage 1 comes back
    at its ref's get while later refs still return, and teardown unlinks
    the rings and leaves both actors alive; microbatches/s and tokens/s
    against this process's forward, and the 18.9 MB handoff's path and
    GB/s.  (b) The same actors as two data-parallel ranks of a declared
    collective group, 6 rows each, their f32 gradients (124M entries)
    summed by ``allreduce`` and halved, then the trainer's AdamW step, 3
    steps: both ranks' parameters equal to the bit after every step, each
    step's loss (the ranks' mean) equal to this process's full-batch step
    within STEP_LOSS_TOL, 12 / 12 / 12 launches a step on each rank; the
    allreduce's seconds and GB/s.  Every process that held the card has
    exited when the phase ends.  Returns the kernels' launches in the
    actors' processes."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step
    from ray_tpu_torch.util import collective

    t_phase = time.monotonic()
    res = {}
    launches = {k: 0 for k in BF16_KERNELS}
    cfg, params = plane_state("cuda")
    split = cfg.n_layers // 2  # stage 0 runs blocks 0-5, stage 1 6-11
    n_tok = BATCH * SEQ
    micro = [torch.from_numpy(plane_rows(i, cfg.vocab_size))
             for i in range(ACTOR_PLANE_MICROBATCHES
                            + ACTOR_PLANE_SEQUENTIAL + 1)]

    # this process's whole forward of every microbatch, and its rate
    want = [plane_forward(params, cfg, r.to("cuda"), 0, cfg.n_layers)
            for r in micro]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in micro[:ACTOR_PLANE_MICROBATCHES]:
        plane_forward(params, cfg, r.to("cuda"), 0, cfg.n_layers)
    torch.cuda.synchronize()
    own_s = time.perf_counter() - t0
    own_rate = ACTOR_PLANE_MICROBATCHES / own_s
    del params
    torch.cuda.empty_cache()

    node = card_runtime(ACTOR_PLANE_STORE_BYTES)
    card_pids = set()
    try:
        t0 = time.monotonic()
        Plane = rt.remote(PlaneActor).options(num_gpus=0.5)
        s0 = Plane.remote(0, split)
        s1 = Plane.remote(split, cfg.n_layers)
        ident = rt.get([s.identity.remote() for s in (s0, s1)],
                       timeout=ACTOR_PLANE_TIMEOUT_S)
        res["start_s"] = time.monotonic() - t0
        card_pids |= {i["pid"] for i in ident}
        print(f"actor plane: two GPT-2 124M actors at num_gpus 0.5 in "
              f"{res['start_s']:.1f} s: pids {[i['pid'] for i in ident]} "
              f"(this process {os.getpid()}) on "
              f"{[i['device'] for i in ident]} under CUDA_VISIBLE_DEVICES "
              f"{[i['visible'] for i in ident]}", flush=True)
        if (os.getpid() in card_pids or len(card_pids) != 2
                or any(i["device"] != "cuda:0" for i in ident)):
            raise SystemExit(f"actor plane: actors {ident}")

        # (a) two pipeline stages over a compiled DAG
        with InputNode() as inp:
            h = s0.forward.bind(inp["tokens"])
            dag = s1.forward.bind(h, inp["tokens"], inp["fail"])
        compiled = dag.experimental_compile()
        rings = [f"/dev/shm/rtpu_chan_{ch.chan_id.hex()}"
                 for ch in compiled._all_channels if ch.native]
        # one microbatch first (untimed): each stage's first forward loads
        # its kernels and libraries, as this process's first one did
        got = [compiled.execute({"tokens": micro[0], "fail": False}).get(
            timeout=ACTOR_PLANE_TIMEOUT_S)]
        t0 = time.perf_counter()
        refs = [compiled.execute({"tokens": r, "fail": False})
                for r in micro[:ACTOR_PLANE_MICROBATCHES]]
        got += [r.get(timeout=ACTOR_PLANE_TIMEOUT_S) for r in refs]
        pipe_s = time.perf_counter() - t0
        # an error in stage 1 on one microbatch, later ones still answered
        bad = compiled.execute({"tokens": micro[-1], "fail": True})
        after = [compiled.execute({"tokens": r, "fail": False})
                 for r in micro[ACTOR_PLANE_MICROBATCHES:-1]]
        try:
            bad.get(timeout=ACTOR_PLANE_TIMEOUT_S)
            error = None
        except ValueError as e:
            error = str(e)
        got += [r.get(timeout=ACTOR_PLANE_TIMEOUT_S) for r in after]
        # one microbatch at a time: the handoff with nothing queued
        for r in micro[ACTOR_PLANE_MICROBATCHES:-1]:
            got.append(compiled.execute({"tokens": r, "fail": False}).get(
                timeout=ACTOR_PLANE_TIMEOUT_S))
        compiled.teardown()
        deadline = time.monotonic() + 10
        while any(os.path.exists(n) for n in rings):
            if time.monotonic() > deadline:
                raise SystemExit(f"actor plane (a): rings left after "
                                 f"teardown: {rings}")
            time.sleep(0.05)
        ident = rt.get([s.identity.remote() for s in (s0, s1)],
                       timeout=ACTOR_PLANE_TIMEOUT_S)  # both still alive

        expect = (want[:1] + want[:ACTOR_PLANE_MICROBATCHES]
                  + 2 * want[ACTOR_PLANE_MICROBATCHES:-1])
        d_loss = max(float((g[0] - w[0].cpu()).abs().max())
                     for g, w in zip(got, expect))
        ids_equal = all(torch.equal(g[1], w[1].cpu())
                        for g, w in zip(got, expect))
        shapes = {(tuple(g[0].shape), str(g[0].dtype)) for g in got}
        per_call = [[c["launches"]["flash_fwd"] for c in i["calls"]]
                    for i in ident]
        for i in ident:
            for c in i["calls"]:
                for k, n in c["launches"].items():
                    launches[k] += n
        # the sequential microbatches: stage 1's entry after stage 0's exit
        seq = ACTOR_PLANE_SEQUENTIAL
        hand_s = sorted(b["t_in"] - a["t_out"] for a, b in zip(
            ident[0]["calls"][-seq:], ident[1]["calls"][-seq:]))
        h2d_s = sorted(c["h2d_s"] for c in ident[1]["calls"][-seq:])
        act_bytes = BATCH * SEQ * cfg.d_model * 2  # bf16
        writes = ident[0]["writes"]
        path = ("spilled through the store from the native ring"
                if writes["spilled"] and not writes["ring"]
                else "native ring" if writes["ring"] and not writes["spilled"]
                else f"mixed {writes}")
        pipe_rate = ACTOR_PLANE_MICROBATCHES / pipe_s
        res["a"] = {
            "microbatches": ACTOR_PLANE_MICROBATCHES, "pipelined_s": pipe_s,
            "microbatches_per_s": pipe_rate,
            "tokens_per_s": pipe_rate * n_tok,
            "own_microbatches_per_s": own_rate,
            "own_tokens_per_s": own_rate * n_tok,
            "max_loss_diff": d_loss, "ids_equal": ids_equal,
            "error": error, "stage_forward_launches": per_call,
            "handoff_bytes": act_bytes, "handoff_s": hand_s,
            "handoff_gbps": act_bytes / hand_s[len(hand_s) // 2] / 1e9,
            "stage1_h2d_s": h2d_s, "stage0_writes": writes,
            "path": path, "rings": len(rings)}
        print(f"actor plane (a): {ACTOR_PLANE_MICROBATCHES} microbatches "
              f"of {BATCH} x {SEQ} tokens pipelined over 2 stages in "
              f"{pipe_s:.3f} s: {pipe_rate:.2f} microbatches/s, "
              f"{pipe_rate * n_tok:.1f} tokens/s; this process's "
              f"{cfg.n_layers}-layer forward {own_rate:.2f} microbatches/s, "
              f"{own_rate * n_tok:.1f} tokens/s (ratio "
              f"{pipe_rate / own_rate:.4f}); losses against this process's "
              f"forward: largest difference {d_loss:.3e} (tol "
              f"{STEP_LOSS_TOL:.0e}) over {len(got)} microbatches, argmax "
              f"ids equal {ids_equal}; stage 1's error at its get: "
              f"{error!r}; forward launches per microbatch (stage 0, stage "
              f"1) {per_call}", flush=True)
        print(f"actor plane (a): the {act_bytes / 1e6:.1f} MB bf16 handoff "
              f"took the {path} path (stage 0's channel writes {writes}): "
              f"{', '.join(f'{t * 1e3:.2f}' for t in hand_s)} ms from stage "
              f"0's return to stage 1's entry, one at a time = "
              f"{res['a']['handoff_gbps']:.3f} GB/s (median), then its H2D "
              f"{', '.join(f'{t * 1e3:.2f}' for t in h2d_s)} ms; teardown "
              f"unlinked {len(rings)} rings, both actors alive", flush=True)
        want_calls = [[split] * (len(got) + 1),
                      [cfg.n_layers - split] * len(got)]
        if not (d_loss <= STEP_LOSS_TOL and ids_equal
                and shapes == {((BATCH,), "torch.float32")}
                and error is not None and "fail" in error
                and per_call == want_calls):
            raise SystemExit(f"actor plane (a) failed: {res['a']}, "
                             f"launches want {want_calls}")

        # (b) data parallelism through util.collective over the same actors
        lr = 3e-4
        collective.declare_collective_group([s0, s1], group_name="dp")
        rt.get([s.dp_init.remote(lr) for s in (s0, s1)],
               timeout=ACTOR_PLANE_TIMEOUT_S)
        steps = []
        for i in range(ACTOR_PLANE_DP_STEPS):
            rows = plane_rows(i, cfg.vocab_size)
            steps.append(rt.get([s.dp_step.remote(rows, r, 2)
                                 for r, s in enumerate((s0, s1))],
                                timeout=ACTOR_PLANE_TIMEOUT_S))
    finally:
        rt.shutdown()
    res["exit_wait_s"] = wait_exited(card_pids, "actor plane")

    # this process's trainer step on all 12 rows from the same parameters
    opt = train_step.default_optimizer(learning_rate=lr, warmup_steps=1)
    _, p0 = plane_state("cuda")
    state = {"params": p0, "opt_state": opt.init(p0), "step": 0}
    run = train_step.make_train_step(gpt2, cfg, opt)
    own_losses = []
    for i in range(ACTOR_PLANE_DP_STEPS):
        state, m = run(state, torch.from_numpy(
            plane_rows(i, cfg.vocab_size)).to("cuda"))
        own_losses.append(m["loss"].item())
    del state, run, p0
    torch.cuda.empty_cache()
    dp_losses = [(a["loss"] + b["loss"]) / 2 for a, b in steps]
    diffs = [abs(a - b) for a, b in zip(dp_losses, own_losses)]
    same = [a["checksums"] == b["checksums"] for a, b in steps]
    want_step = {k: cfg.n_layers for k in BF16_KERNELS}
    step_launches = [[r["launches"] for r in s] for s in steps]
    for s in steps:
        for r in s:
            for k, n in r["launches"].items():
                launches[k] += n
    ar = [r["allreduce_s"] for s in steps for r in s]
    nbytes = steps[0][0]["bytes"]
    res["b"] = {
        "steps": ACTOR_PLANE_DP_STEPS, "lr": lr, "rank_losses": [
            [r["loss"] for r in s] for s in steps],
        "losses": dp_losses, "own_losses": own_losses, "loss_diffs": diffs,
        "params_equal": same, "launches": step_launches,
        "allreduce_s": ar, "allreduce_bytes": nbytes,
        "allreduce_gbps": [nbytes / t / 1e9 for t in ar],
        "h2d_s": [r["h2d_s"] for s in steps for r in s],
        "returned": sorted({(r["dtype"], r["device"]) for s in steps
                            for r in s})}
    print(f"actor plane (b): 2 ranks x {BATCH // 2} rows, "
          f"{ACTOR_PLANE_DP_STEPS} "
          f"steps: losses (the ranks' mean) "
          f"{', '.join(f'{x:.6f}' for x in dp_losses)} against this "
          f"process's full-batch step "
          f"{', '.join(f'{x:.6f}' for x in own_losses)} (largest difference "
          f"{max(diffs):.3e}, tol {STEP_LOSS_TOL:.0e}); parameters equal "
          f"to the bit on both ranks after each step {same}; launches per "
          f"step per rank {step_launches}; allreduce of {nbytes / 1e6:.1f} "
          f"MB f32 (came back {res['b']['returned']}): "
          f"{', '.join(f'{t:.3f}' for t in ar)} s = "
          f"{', '.join(f'{g:.3f}' for g in res['b']['allreduce_gbps'])} "
          f"GB/s", flush=True)
    if not (all(same) and max(diffs) <= STEP_LOSS_TOL
            and all(r == want_step for s in step_launches for r in s)
            and res["b"]["returned"] == [("torch.float32", "cpu")]):
        raise SystemExit(f"actor plane (b) failed: {res['b']}")
    res["launches"] = launches
    res["phase_s"] = time.monotonic() - t_phase
    report["actor_plane"] = res
    print(f"actor plane: launches in the actors' processes {launches}; the "
          f"2 processes that held the card exited {res['exit_wait_s']:.2f} "
          f"s after the shutdown; session {node.session_dir}; phase "
          f"{res['phase_s']:.1f} s", flush=True)
    return launches


# The data plane on the card (``run_data``).  (a) ``build_llm_processor``
# over the serving model in two engine actors at ``num_gpus`` 0.5: 64
# prompts in 4 blocks of 16 rows, one engine call a block.  (b) A
# preprocessing pipeline (``range`` -> ``map_batches`` making each row's
# token ids from ``default_rng(DATA_SEED + id)``, the stand-in for
# tokenization -> seeded ``random_shuffle``) into ``TorchTrainer``'s one
# GPU worker through ``streaming_split``'s coordinator, phase 9's step.
DATA_SEED = 37
DATA_PROMPTS, DATA_BLOCKS, DATA_BATCH, DATA_MAX_TOKENS = 64, 4, 16, 32
DATA_WARMUP, DATA_TIMED = 3, 8  # (b): 11 steps of BATCH rows
DATA_ROWS = (DATA_WARMUP + DATA_TIMED) * BATCH


def data_engine_udf():
    """``_EngineUDF`` reporting, in each output batch, its process's pid,
    whether the process made a CUDA context, the forward kernel's
    launches in the process before and after the batch, the batch's
    start and end and when the engine became ready (``time.time()``).
    Made in a function so that it travels by value."""
    from ray_tpu_torch.llm import batch as batch_mod

    class ProbedEngineUDF(batch_mod._EngineUDF):
        def __init__(self, config):
            super().__init__(config)
            self._ready_at = time.time()

        def __call__(self, batch):
            import numpy as np
            import torch

            from ray_tpu_torch.ops import attention

            before = attention.flash_forward.launches
            start = time.time()
            out = super().__call__(batch)
            torch.cuda.synchronize()
            end = time.time()
            n = len(out["prompt"])
            probes = {"pid": os.getpid(),
                      "cuda": torch.cuda.is_initialized(),
                      "launches_before": before,
                      "launches_after": attention.flash_forward.launches,
                      "start": start, "end": end,
                      "ready_at": self._ready_at}
            for k, v in probes.items():
                out[k] = np.full(n, v)
            return out

    return ProbedEngineUDF


def data_make_rows(batch, vocab):
    """Each row's SEQ + 1 token ids, from ``default_rng(DATA_SEED + id)``
    below ``vocab``."""
    import numpy as np

    return {"tokens": np.stack([
        np.random.default_rng(DATA_SEED + int(i)).integers(0, vocab, SEQ + 1)
        for i in batch["id"]])}


def data_pipeline(data, vocab):
    return data.range(DATA_ROWS).map_batches(
        data_make_rows, fn_kwargs={"vocab": vocab}).random_shuffle(
            seed=DATA_SEED)


def data_processor_config():
    from ray_tpu_torch.llm import EngineConfig
    from ray_tpu_torch.llm.batch import ProcessorConfig

    return ProcessorConfig(
        model_loader=serve_model_loader,
        engine_config=EngineConfig(max_slots=16, num_pages=512,
                                   page_size=16, max_seq_len=1024),
        concurrency=2, num_gpus=0.5, batch_size=DATA_BATCH,
        sampling={"max_tokens": DATA_MAX_TOKENS})


def run_data_processor(report, res):
    """(a): returns the forward kernel's launches in the engine actors'
    processes and their pids."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.llm import batch as batch_mod

    prompts = [frontend_prompt(300 + i, 64) for i in range(DATA_PROMPTS)]
    config = data_processor_config()
    probed = data_engine_udf()
    genuine = batch_mod._EngineUDF
    batch_mod._EngineUDF = probed  # the processor's map_batches takes it
    try:
        ds = batch_mod.build_llm_processor(config)(data.from_items(
            [{"prompt": p} for p in prompts],
            override_num_blocks=DATA_BLOCKS))
    finally:
        batch_mod._EngineUDF = genuine
    t0 = time.time()
    rows = ds.take_all()
    wall = time.time() - t0
    n_tok = sum(len(r["generated_tokens"]) for r in rows)
    pids = sorted({int(r["pid"]) for r in rows})
    batches = {}  # (pid, start) -> the batch's rows
    for r in rows:
        batches.setdefault((int(r["pid"]), float(r["start"])), []).append(r)
    launches = {pid: sum(int(b[0]["launches_after"])
                         - int(b[0]["launches_before"])
                         for (p, _), b in batches.items() if p == pid)
                for pid in pids}
    span = (max(float(r["end"]) for r in rows)
            - min(float(r["start"]) for r in rows))
    ready_s = max(float(r["ready_at"]) for r in rows) - t0
    engine_rate = report["engine"]["output_tok_s"]
    res["a"] = {
        "rows": len(rows), "tokens": n_tok, "pids": pids,
        "batches": len(batches), "launches_by_pid": launches,
        "cuda": sorted({bool(r["cuda"]) for r in rows}),
        "tok_s_span": n_tok / span, "tok_s_wall": n_tok / wall,
        "span_s": span, "wall_s": wall, "actors_ready_s": ready_s,
        "engine_tok_s": engine_rate}
    print(f"data (a): build_llm_processor, 2 engine actors at num_gpus 0.5 "
          f"(pids {pids}, this process {os.getpid()}), {len(rows)} rows in "
          f"{len(batches)} batches of {DATA_BATCH}, {n_tok} tokens: "
          f"{n_tok / span:.1f} output tok/s over the batches' span "
          f"({span:.3f} s) = {n_tok / span / engine_rate:.4f} of "
          f"run_engine's {engine_rate:.1f}; {n_tok / wall:.1f} tok/s over "
          f"the wall time with the actors' start ({wall:.3f} s); both "
          f"actors ready {ready_s:.2f} s after take_all; forward launches "
          f"by process {launches}", flush=True)
    short = [len(r["generated_tokens"]) for r in rows
             if len(r["generated_tokens"]) != DATA_MAX_TOKENS]
    if (len(rows) != DATA_PROMPTS or short
            or [r["prompt"] for r in rows] != prompts):
        raise SystemExit(f"data (a): {len(rows)} rows, short {short}")
    if len(pids) != 2 or os.getpid() in pids or res["a"]["cuda"] != [True]:
        raise SystemExit(f"data (a): engine processes {pids}, CUDA "
                         f"{res['a']['cuda']}")
    if not all(n > 0 for n in launches.values()):
        raise SystemExit(f"data (a): forward launches by process {launches}")
    return rows, sum(launches.values()), pids


def data_reference_ids(rows):
    """(a)'s batches through ``_EngineUDF``s built in this process on the
    same config, one for each engine actor, fed that actor's batches in
    the order it ran them: an engine's prefix cache makes the path of a
    prefill depend on the engine's history (a prompt sharing only its BOS
    token with an earlier one takes the suffix path, ROADMAP.md's faults
    ported as they are), so each reference engine must have the actor's
    history.  Returns how many rows' ids differ."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import batch as batch_mod

    by_pid = {}  # pid -> its batches' rows, in the order it ran them
    for r in rows:
        by_pid.setdefault(int(r["pid"]), {}).setdefault(
            float(r["start"]), []).append(r)
    differ = 0
    for pid, batches in sorted(by_pid.items()):
        udf = batch_mod._EngineUDF(data_processor_config())
        try:
            for _, chunk in sorted(batches.items()):
                want = udf({"prompt": np.array([r["prompt"]
                                                for r in chunk])})
                differ += sum(
                    list(map(int, r["generated_tokens"]))
                    != list(map(int, w))
                    for r, w in zip(chunk, want["generated_tokens"]))
        finally:
            udf.shutdown()
            del udf
            torch.cuda.empty_cache()
    return differ


def run_data_trainer(report, res):
    """(b): returns the worker's launches and its pid."""
    import hashlib
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ray_tpu_torch import data, train
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)  # run_trainer's
    n_steps = DATA_WARMUP + DATA_TIMED
    config = {"cfg": cfg, "seed": DATA_SEED, "batch": BATCH,
              "warmup": DATA_WARMUP, "timed": DATA_TIMED}
    os.makedirs(OUT_DIR, exist_ok=True)
    storage = tempfile.mkdtemp(dir=OUT_DIR)
    t0 = time.monotonic()
    try:
        result = train.TorchTrainer(
            torch_trainer_loop, train_loop_config=config,
            torch_config=train.TorchConfig(),
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(name="data_trainer",
                                       storage_path=storage),
            datasets={"train": data_pipeline(data, cfg.vocab_size)}).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.monotonic() - t0
    if result.error is not None:
        raise SystemExit(f"data (b): the TorchTrainer loop failed: "
                         f"{result.error}")
    m = result.metrics

    # the same pipeline in this process, and its stats
    ds = data_pipeline(data, cfg.vocab_size)
    t0 = time.monotonic()
    own = [b["tokens"] for b in ds.iter_batches(batch_size=BATCH)]
    own_s = time.monotonic() - t0
    own_sha = [hashlib.sha256(np.ascontiguousarray(b).tobytes()).hexdigest()
               for b in own]
    stats = ds.stats()

    # this process's own first step on the same parameters and first rows
    gen = torch.Generator(device="cuda").manual_seed(DATA_SEED)
    opt = train_step.default_optimizer(warmup_steps=1)
    state = train_step.create_train_state(gpt2, cfg, opt, gen, device="cuda")
    step = train_step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    _, first = step(state, torch.from_numpy(own[0]).cuda().long())
    own_loss = first["loss"].item()
    del state, step, first
    torch.cuda.empty_cache()

    waits = np.asarray(m["wait_ms"][DATA_WARMUP:])
    ref_rate = report["torch_trainer"]["tokens_per_s"]
    want = {k: cfg.n_layers * n_steps for k in m["launches"]}
    res["b"] = dict(
        m, fit_s=fit_s, own_first_loss=own_loss, own_batch_sha256=own_sha,
        own_s=own_s, stats=stats, tokens_per_s_ratio=m["tokens_per_s"]
        / ref_rate, wait_ms_p50=float(np.percentile(waits, 50)))
    print(f"data (b): TorchTrainer fed by range -> map_batches -> "
          f"random_shuffle(seed={DATA_SEED}) through streaming_split "
          f"(worker pid {m['pid']}, coordinator pid {m['coordinator_pid']}, "
          f"this process {os.getpid()}; {fit_s:.1f} s for fit): {n_steps} "
          f"steps of GPT-2 124M, loss first {m['losses'][0]:.6f} against "
          f"this process's own step {own_loss:.6f} (diff "
          f"{abs(m['losses'][0] - own_loss):.3e}, tol {STEP_LOSS_TOL:.0e}); "
          f"{m['step_ms']:.3f} ms a timed step, {m['tokens_per_s']:.1f} "
          f"tokens/s = {res['b']['tokens_per_s_ratio']:.4f} of "
          f"run_torch_trainer's {ref_rate:.1f}; next(batch) wait p50 "
          f"{res['b']['wait_ms_p50']:.4f} ms; batches equal to this "
          f"process's run of the pipeline "
          f"{sum(a == b for a, b in zip(m['batch_sha256'], own_sha))} of "
          f"{len(own_sha)}; worker launches {m['launches']}; the pipeline "
          f"in this process ({own_s:.2f} s): "
          + "; ".join(stats.splitlines()), flush=True)
    if os.getpid() in (m["pid"], m["coordinator_pid"]) or not m[
            "coordinator_pid"]:
        raise SystemExit(f"data (b): worker pid {m['pid']}, coordinator pid "
                         f"{m['coordinator_pid']}")
    if m["batch_sha256"] != own_sha or not m["exhausted"]:
        raise SystemExit("data (b): the batches the worker consumed are not "
                         "this process's run of the pipeline, in order")
    if abs(m["losses"][0] - own_loss) > STEP_LOSS_TOL:
        raise SystemExit("data (b): the worker's first loss disagrees with "
                         "this process's step on the same rows")
    if m["launches"] != want:
        raise SystemExit(f"data (b): worker launches {m['launches']}, want "
                         f"{want}")
    return m["launches"], m["pid"]


# (c): the data service feeding a trainer from files.  (b)'s pipeline is
# written as TFRecords (one file a block), read back by the service's
# workers through ``read_tfrecords`` and one ``map_batches`` stage, and a
# TorchTrainer worker attached to the job's one split trains two epochs
# over it.
DATA_SERVICE_JOB = "data-smoke-tokens"
DATA_SERVICE_EPOCHS = 2
DATA_SERVICE_MIN_FILES = 4
DATA_SERVICE_TIMEOUT_S = 60  # the job's snapshot after the fit


def data_service_tokens(batch):
    """(c)'s stage: the token column as an (n, SEQ + 1) int64 array."""
    import numpy as np

    tokens = np.stack([np.asarray(t, dtype=np.int64)
                       for t in batch["tokens"]])
    if tokens.shape[1:] != (SEQ + 1,):
        raise ValueError(f"token rows of shape {tokens.shape}")
    return {"tokens": tokens}


def row_sha256(rows) -> list:
    """The sha256 of each int64 row of ``rows``."""
    import hashlib

    import numpy as np

    rows = np.ascontiguousarray(np.asarray(rows, dtype=np.int64))
    return [hashlib.sha256(r.tobytes()).hexdigest() for r in rows]


def service_trainer_loop(config):
    """(c)'s train function, in the trainer's worker: attaches to the data
    service's job and trains the GPT-2 124M step over ``epochs`` passes of
    its split (each ``iter_torch_batches`` pass over the attached
    iterator is one epoch of the service), ``steps`` a pass.  Reports the
    losses, each ``next(batch)`` wait, each epoch's timed device ms (the
    steps after ``warmup``), the sha256 of every row consumed by epoch, the
    first batch, when the loop started, and the worker's launches over the
    loop."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.data import service
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step

    started = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(train.get_context().get_device())
    cfg = config["cfg"]
    opt = train_step.default_optimizer(warmup_steps=1)
    gen = torch.Generator(device=device).manual_seed(config["seed"])
    state = train_step.create_train_state(gpt2, cfg, opt, gen, device=device)
    step = train_step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    it = service.attach(config["job"], 0)
    zero_launch_counts()
    epochs = []
    for _ in range(config["epochs"]):
        batches = iter(it.iter_torch_batches(
            batch_size=config["batch"], drop_last=True, device=device))
        timed = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        kept, waits, losses = [], [], []
        for i in range(config["steps"]):
            if i == config["warmup"]:
                torch.cuda.synchronize(device)
                timed[0].record()
            t0 = time.perf_counter()
            batch = next(batches)
            waits.append((time.perf_counter() - t0) * 1e3)
            kept.append(batch["tokens"])
            state, m = step(state, batch["tokens"].long())
            losses.append(m["loss"])
        timed[1].record()
        torch.cuda.synchronize(device)
        exhausted = next(batches, None) is None
        rows = torch.cat(kept).cpu().numpy()
        timed_ms = timed[0].elapsed_time(timed[1])
        epochs.append({
            "rows_sha256": row_sha256(rows), "rows": rows.shape[0],
            "exhausted": exhausted, "wait_ms": waits,
            "losses": [float(x) for x in losses], "timed_ms": timed_ms,
            "tokens_per_s": (config["steps"] - config["warmup"])
            * config["batch"] * (rows.shape[1] - 1) / (timed_ms / 1e3)})
        if len(epochs) == 1:
            first_batch = kept[0].cpu().numpy()
    train.report({
        "epochs": epochs, "first_batch": first_batch,
        "started": started, "launches": launch_counts(),
        "device": torch.cuda.get_device_name(device), "pid": os.getpid()})


def service_processes(inst, job):
    """In the data service's coordinator: (pid, whether the process made
    a CUDA context) of the coordinator and of each of ``job``'s workers."""
    import ray_tpu_torch as rt

    out = {"coordinator": process_cuda(inst)}
    for wid, w in list(inst._jobs[job].workers.items()):
        out[wid] = rt.get(w.handle.__rtpu_apply__.remote(process_cuda),
                          timeout=60)
    return out


def dir_files(path: str) -> list:
    return sorted(os.path.join(path, f) for f in os.listdir(path))


def run_data_service(report, res):
    """(c), on ``run_data``'s runtime: ``data_pipeline`` materialized and
    written with ``write_tfrecords`` (one file a block, at least
    DATA_SERVICE_MIN_FILES), read back whole (the write's and the read's
    MB/s over the files' bytes); ``read_tfrecords`` ->
    ``map_batches(data_service_tokens)`` registered with the data service
    at one split, and ``service_trainer_loop`` in a ``TorchTrainer``
    worker on the card attached to it for DATA_SERVICE_EPOCHS epochs.
    Fails unless each epoch's rows are the pipeline's as a multiset
    (sha256 a row) and run out, the job's ``data_jobs`` snapshot counts
    both epochs' rows with the second served from the first-epoch cache
    (hits at least the chunks, no miss), the worker's first loss equals
    this process's step on its first batch within STEP_LOSS_TOL, every
    kernel launched 12 times a step, and the coordinator and the job's
    workers run in processes other than this one with no CUDA context.
    Returns the worker's launches and its pid."""
    import shutil
    import tempfile
    from collections import Counter

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, train
    from ray_tpu_torch._private import data_service as svc_mod
    from ray_tpu_torch.data import service
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.train import step as train_step
    from ray_tpu_torch.util import state as state_api

    cfg = gpt2.GPT2Config(remat=False, loss_chunk=0)  # run_trainer's
    steps = DATA_ROWS // BATCH
    os.makedirs(OUT_DIR, exist_ok=True)
    files_dir = tempfile.mkdtemp(dir=OUT_DIR)
    storage = tempfile.mkdtemp(dir=OUT_DIR)
    try:
        pipeline = data_pipeline(data, cfg.vocab_size).materialize()
        own_rows = np.concatenate([b["tokens"] for b in pipeline.iter_batches(
            batch_size=None)])
        t0 = time.monotonic()
        pipeline.write_tfrecords(files_dir)
        write_s = time.monotonic() - t0
        files = dir_files(files_dir)
        file_bytes = sum(os.path.getsize(f) for f in files)
        t0 = time.monotonic()
        read_rows = sum(len(b["tokens"]) for b in data.read_tfrecords(
            files_dir).iter_batches(batch_size=None))
        read_s = time.monotonic() - t0
        ds = data.read_tfrecords(files_dir).map_batches(data_service_tokens)
        info = service.register(DATA_SERVICE_JOB, ds, num_splits=1)
        config = {"cfg": cfg, "seed": DATA_SEED, "batch": BATCH,
                  "warmup": DATA_WARMUP, "steps": steps,
                  "epochs": DATA_SERVICE_EPOCHS, "job": DATA_SERVICE_JOB}
        t0 = time.monotonic()
        fit_start = time.time()
        try:
            result = train.TorchTrainer(
                service_trainer_loop, train_loop_config=config,
                torch_config=train.TorchConfig(),
                scaling_config=train.ScalingConfig(num_workers=1,
                                                   use_gpu=True),
                run_config=train.RunConfig(name="data_service_trainer",
                                           storage_path=storage)).fit()
            fit_s = time.monotonic() - t0
            if result.error is not None:
                raise SystemExit(f"data (c): the TorchTrainer loop failed: "
                                 f"{result.error}")
            want_rows = DATA_SERVICE_EPOCHS * DATA_ROWS
            deadline = time.monotonic() + DATA_SERVICE_TIMEOUT_S
            while True:
                snap = next((j for j in state_api.list_data_jobs()
                             if j.get("name") == DATA_SERVICE_JOB), None)
                if (snap and snap["rows_total"] >= want_rows) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            coord = rt.get_actor(svc_mod.COORDINATOR_NAME)
            procs = rt.get(coord.__rtpu_apply__.remote(
                service_processes, DATA_SERVICE_JOB), timeout=120)
        finally:
            service.unregister(DATA_SERVICE_JOB)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        shutil.rmtree(files_dir, ignore_errors=True)
    m = result.metrics

    # this process's own first step on the same parameters and the
    # worker's first batch
    gen = torch.Generator(device="cuda").manual_seed(DATA_SEED)
    opt = train_step.default_optimizer(warmup_steps=1)
    st = train_step.create_train_state(gpt2, cfg, opt, gen, device="cuda")
    step = train_step.make_train_step(gpt2, cfg, opt, attn_impl="flash")
    _, first = step(st, torch.from_numpy(m["first_batch"]).cuda().long())
    own_loss = first["loss"].item()
    del st, step, first
    torch.cuda.empty_cache()

    own_sha = Counter(row_sha256(own_rows))
    epochs = m["epochs"]
    ref_rate = report["torch_trainer"]["tokens_per_s"]
    mb = file_bytes / 1e6
    per_epoch = [{
        "rows": e["rows"], "exhausted": e["exhausted"],
        "tokens_per_s": e["tokens_per_s"],
        "tokens_per_s_ratio": e["tokens_per_s"] / ref_rate,
        "wait_ms_p50": float(np.percentile(e["wait_ms"], 50)),
        "first_wait_ms": e["wait_ms"][0],
        "rows_equal_pipeline": Counter(e["rows_sha256"]) == own_sha,
        "first_loss": e["losses"][0], "last_loss": e["losses"][-1]}
        for e in epochs]
    want = {k: cfg.n_layers * steps * DATA_SERVICE_EPOCHS
            for k in m["launches"]}
    res["c"] = {
        "files": len(files), "file_bytes": file_bytes, "write_s": write_s,
        "write_mb_s": mb / write_s, "read_s": read_s, "read_rows": read_rows,
        "read_mb_s": mb / read_s, "register": info, "fit_s": fit_s,
        "worker_ready_s": m["started"] - fit_start, "epochs": per_epoch,
        "own_first_loss": own_loss, "launches": m["launches"],
        "processes": procs, "snapshot": snap, "pid": m["pid"]}
    print(f"data (c): (b)'s pipeline written with write_tfrecords to "
          f"{len(files)} files, {file_bytes} bytes, in {write_s:.3f} s "
          f"({mb / write_s:.2f} MB/s); read_tfrecords read {read_rows} rows "
          f"in {read_s:.3f} s ({mb / read_s:.2f} MB/s); the data service's "
          f"job {info}; TorchTrainer worker (pid {m['pid']}, loop started "
          f"{m['started'] - fit_start:.2f} s after fit began; {fit_s:.1f} s "
          f"for fit) over {DATA_SERVICE_EPOCHS} epochs of {steps} steps of "
          f"GPT-2 124M: first loss {epochs[0]['losses'][0]:.6f} against "
          f"this process's step on the worker's first batch {own_loss:.6f} "
          f"(diff {abs(epochs[0]['losses'][0] - own_loss):.3e}, tol "
          f"{STEP_LOSS_TOL:.0e}); worker launches {m['launches']}", flush=True)
    for i, e in enumerate(per_epoch):
        print(f"data (c) epoch {i}: {e['rows']} rows, equal to the "
              f"pipeline's as a multiset: {e['rows_equal_pipeline']}; "
              f"{e['tokens_per_s']:.1f} tokens/s over steps "
              f"{DATA_WARMUP}-{steps - 1} = {e['tokens_per_s_ratio']:.4f} of "
              f"run_torch_trainer's {ref_rate:.1f}; next(batch) wait p50 "
              f"{e['wait_ms_p50']:.4f} ms, the first "
              f"{e['first_wait_ms']:.2f} ms; loss {e['first_loss']:.6f} -> "
              f"{e['last_loss']:.6f}", flush=True)
    print(f"data (c): the service's processes (pid, CUDA context) {procs}, "
          f"this process {os.getpid()}; the job's snapshot "
          f"{json.dumps(snap, sort_keys=True)}", flush=True)
    if len(files) < DATA_SERVICE_MIN_FILES or read_rows != DATA_ROWS:
        raise SystemExit(f"data (c): {len(files)} files, {read_rows} rows "
                         f"read back")
    if not all(e["rows_equal_pipeline"] and e["exhausted"]
               and e["rows"] == DATA_ROWS for e in per_epoch):
        raise SystemExit("data (c): an epoch's rows are not the pipeline's")
    if not (snap and snap["rows_total"] == DATA_SERVICE_EPOCHS * DATA_ROWS
            and snap["cache"]["hits"] >= snap["chunks"]
            and snap["cache"]["misses"] == 0):
        raise SystemExit(f"data (c): the second epoch was not served from "
                         f"the first-epoch cache: {snap}")
    if abs(epochs[0]["losses"][0] - own_loss) > STEP_LOSS_TOL:
        raise SystemExit("data (c): the worker's first loss disagrees with "
                         "this process's step on the same batch")
    if not all(map(math.isfinite, [x for e in epochs
                                   for x in e["losses"]])):
        raise SystemExit("data (c): a loss is not finite")
    if m["launches"] != want:
        raise SystemExit(f"data (c): worker launches {m['launches']}, want "
                         f"{want}")
    pids = [p for p, _ in procs.values()]
    if (len(procs) < 2 or os.getpid() in pids + [m["pid"]]
            or any(cuda for _, cuda in procs.values())):
        raise SystemExit(f"data (c): the service's processes {procs} (pid, "
                         f"CUDA context), this process {os.getpid()}")
    return m["launches"], m["pid"]


def run_data(report):
    """The data plane on the card (after ``run_actor_plane``), on the
    port's runtime.  (a) ``build_llm_processor`` with two engine actors at
    ``num_gpus`` 0.5 over ``from_items`` of 64 prompts in 4 blocks
    (``data_engine_udf`` reports from each batch): 64 rows of 32 tokens
    from two processes other than this one, each launching the forward
    kernel, the ids of every row equal to the bit to the same batch
    through an ``_EngineUDF`` in this process with the same history
    (``data_reference_ids``); tok/s over the batches' span and over the
    wall time against ``run_engine``'s, the actors' seconds to ready.  (b) ``TorchTrainer`` with one GPU worker fed by
    ``data_pipeline`` through ``streaming_split``'s coordinator into
    phase 9's step, 3 warm-up and 8 timed steps: the worker's and the
    coordinator's pids not this one's, each batch's sha256 equal to this
    process's run of the pipeline in order, the first loss equal to this
    process's step within STEP_LOSS_TOL, 12 / 12 / 12 launches a step;
    tokens/s against ``run_torch_trainer``'s, ``next(batch)`` p50, and the
    in-process run's stats.  (c) ``run_data_service``: (b)'s pipeline
    written as TFRecords, served by the data service to a ``TorchTrainer``
    worker over two epochs: the rows, the cache, the first loss, the
    launches and the service's processes.
    Every process that held the card has exited when the phase ends.
    Returns the kernels' launches on the phase's paths."""
    import ray_tpu_torch as rt

    t_phase = time.monotonic()
    res = {}
    node = card_runtime()
    card_pids = set()
    try:
        rows, fwd_a, pids = run_data_processor(report, res)
        card_pids |= set(pids)
        res["a"]["exit_wait_s"] = wait_exited(pids, "data (a)")
        launches, worker_pid = run_data_trainer(report, res)
        card_pids.add(worker_pid)
        service_launches, service_pid = run_data_service(report, res)
        card_pids.add(service_pid)
    finally:
        rt.shutdown()
    res["exit_wait_s"] = wait_exited(card_pids, "data")
    differ = data_reference_ids(rows)
    res["a"]["ids_differ"] = differ
    print(f"data (a): rows whose ids differ from this process's "
          f"_EngineUDFs on the same batches in the actors' order: {differ} "
          f"of {len(rows)}", flush=True)
    if differ:
        raise SystemExit(f"data (a): {differ} rows' ids differ from this "
                         f"process's engine")
    launches = {k: v + service_launches[k] for k, v in launches.items()}
    launches["flash_fwd"] += fwd_a
    res["launches"] = launches
    res["phase_s"] = time.monotonic() - t_phase
    report["data"] = res
    print(f"data: launches on the phase's paths {launches}; the "
          f"{len(card_pids)} processes that held the card exited; session "
          f"{node.session_dir}; phase {res['phase_s']:.1f} s", flush=True)
    return launches


# The autoscaler on the card (``run_autoscaler``): batch inference over a
# MongoDB collection on a GPU node that the autoscaler brings up.  The
# head is an in-process node, which would add this host's card to its
# resources: it is told ``"GPU": 0`` so that the engine actor waits for a
# launched node.
AUTOSCALER_DOCS = 32
AUTOSCALER_BLOCKS = 4
AUTOSCALER_IDLE_S = 5.0
AUTOSCALER_JOIN_S = 120  # the launched node's wait to join the GCS
AUTOSCALER_END_S = 60  # the idle node's wait to be terminated
AUTOSCALER_TIMEOUT_S = 600  # the processor's whole run


def smoke_mongod(docs, log):
    """A MongoDB server for the phase, on the port's BSON codec
    (``tests/test_data_extras.py``'s ``_fake_mongod``): OP_MSG ``find``
    with ``_id`` ranges, ``sort``, ``projection`` and ``limit``, and
    ``getMore``, on ``127.0.0.1`` in this process, one thread a
    connection; each command's ``time.time()`` and decoded document go
    to ``log``.  Returns the listening socket and its port."""
    import socket
    import struct
    import threading

    from ray_tpu_torch.data import mongo as M

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    cursors, next_cursor, lock = {}, [1000], threading.Lock()

    def match(doc, flt):
        for k, cond in (flt or {}).items():
            if k == "$and":
                if not all(match(doc, f) for f in cond):
                    return False
                continue
            v = doc.get(k)
            if isinstance(cond, dict):
                for op, bound in cond.items():
                    if ((op == "$gte" and not v >= bound)
                            or (op == "$lt" and not v < bound)
                            or (op == "$lte" and not v <= bound)):
                        return False
            elif v != cond:
                return False
        return True

    def cursor(rows, bs, coll):
        batch, rest = rows[:bs], rows[bs:]
        cid = 0
        if rest:
            with lock:
                cid = next_cursor[0]
                next_cursor[0] += 1
                cursors[cid] = (rest, coll)
        return batch, cid

    def serve(conn):
        try:
            while True:
                hdr = b""
                while len(hdr) < 16:
                    c = conn.recv(16 - len(hdr))
                    if not c:
                        return
                    hdr += c
                length, rid, _, _ = struct.unpack("<iiii", hdr)
                body = b""
                while len(body) < length - 16:
                    body += conn.recv(length - 16 - len(body))
                cmd, _ = M.decode_document(body, 5)
                log.append((time.time(), cmd))
                ns = f"{cmd['$db']}."
                if "find" in cmd:
                    rows = [d for d in docs if match(d, cmd.get("filter"))]
                    if "sort" in cmd:
                        key, direction = next(iter(cmd["sort"].items()))
                        rows.sort(key=lambda d: d[key],
                                  reverse=direction < 0)
                    if cmd.get("projection"):
                        keep = [k for k, v in cmd["projection"].items() if v]
                        rows = [{k: d[k] for k in keep if k in d}
                                for d in rows]
                    if cmd.get("limit"):
                        rows = rows[:cmd["limit"]]
                    batch, cid = cursor(rows, cmd.get("batchSize", 101),
                                        cmd["find"])
                    reply = {"cursor": {"firstBatch": batch, "id": cid,
                                        "ns": ns + cmd["find"]}, "ok": 1.0}
                elif "getMore" in cmd:
                    with lock:
                        rest, coll = cursors.pop(cmd["getMore"], ([], ""))
                    batch, cid = cursor(rest, cmd.get("batchSize", 101),
                                        coll)
                    reply = {"cursor": {"nextBatch": batch, "id": cid,
                                        "ns": ns + coll}, "ok": 1.0}
                else:
                    reply = {"ok": 0.0, "errmsg": "unknown command"}
                payload = b"\x00" * 5 + M.encode_document(reply)
                conn.sendall(struct.pack("<iiii", 16 + len(payload), 1, rid,
                                         2013) + payload)
        except OSError:
            pass
        finally:
            conn.close()

    def accept_loop():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            threading.Thread(target=serve, args=(c,), daemon=True).start()

    threading.Thread(target=accept_loop, daemon=True).start()
    return srv, srv.getsockname()[1]


def autoscaler_engine_udf():
    """``data_engine_udf``'s probed UDF that also reports, in each output
    batch, the node id of the process it ran in."""
    base = data_engine_udf()

    class NodeProbedEngineUDF(base):
        def __call__(self, batch):
            import numpy as np

            import ray_tpu_torch

            out = super().__call__(batch)
            out["node"] = np.full(
                len(out["prompt"]),
                ray_tpu_torch.get_runtime_context().node_id_hex())
            return out

    return NodeProbedEngineUDF


def process_tree(pid: int) -> set:
    """``pid`` and every process below it."""
    parents = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    parents[int(name)] = int(
                        f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError):
                pass
    out, frontier = {pid}, {pid}
    while frontier:
        frontier = {p for p, pp in parents.items() if pp in frontier}
        out |= frontier
    return out


def run_autoscaler(report):
    """The autoscaler on the card (after ``run_data``): an
    ``AutoscalingCluster`` of a card-less head (``{"CPU": 2, "GPU": 0}``)
    and one node type ``{"CPU": 2, "GPU": 1}`` (max 1, idle after
    AUTOSCALER_IDLE_S, a tick a second); ``build_llm_processor`` over
    ``read_mongo`` of AUTOSCALER_DOCS documents ``{"_id", "prompt"}`` in
    AUTOSCALER_BLOCKS ``_id`` ranges from ``smoke_mongod``, one engine
    actor at ``num_gpus`` 1 (``data_processor_config``'s engine at the
    serving width).  Fails unless exactly one node was launched, the
    actor ran in a process of it (not this one) with its node id, its
    rows hold CUDA results and the forward kernel's launches, each row's
    prompt is its document's, the ids equal to the bit those of an
    ``_EngineUDF`` in this process fed the same batches in the actor's
    order, and the idle node is terminated, dead in the GCS and every
    process of it exited.  Returns the forward kernel's launches in the
    actor's process."""
    import dataclasses
    import struct
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import cluster_utils, data
    from ray_tpu_torch.autoscaler import AutoscalerConfig, NodeTypeConfig
    from ray_tpu_torch.data.mongo import ObjectId
    from ray_tpu_torch.llm import batch as batch_mod

    t_phase = time.monotonic()
    res = {}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p and p != HERE])
    # ObjectIds as a server makes them: 4 bytes of seconds, 5 of process,
    # 3 of counter
    docs = [{"_id": ObjectId(struct.pack(">I", 1_760_000_000 + i)
                             + bytes.fromhex("a1b2c3d4e5")
                             + i.to_bytes(3, "big")),
             "prompt": frontend_prompt(400 + i, 64)}
            for i in range(AUTOSCALER_DOCS)]
    want = {d["_id"].raw.hex(): d["prompt"] for d in docs}
    commands = []
    srv, port = smoke_mongod(docs, commands)
    asc = cluster_utils.AutoscalingCluster(
        head_resources={"CPU": 2.0, "GPU": 0.0},
        autoscaler_config=AutoscalerConfig(
            node_types={"gpu": NodeTypeConfig(
                resources={"CPU": 2.0, "GPU": 1.0}, max_workers=1)},
            idle_timeout_s=AUTOSCALER_IDLE_S, interval_s=1.0),
        min_workers=2, object_store_memory=RUNTIME_STORE_BYTES)
    head = asc.cluster.head_node
    created = []  # (node id, type, resources, time.time())
    create = asc.provider.create_node
    asc.provider.create_node = lambda t, r, nid: (
        created.append((nid, t, dict(r), time.time())), create(t, r, nid))
    seen = {}  # node id -> {"joined", "dead", "procs"}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            for n in head.gcs.list_nodes():
                if n.is_head:
                    continue
                w = seen.setdefault(n.node_id, {"joined": time.time(),
                                                "dead": None,
                                                "procs": set()})
                proc = asc.provider._procs.get(n.node_id)
                if n.alive and proc is not None:
                    w["procs"] |= process_tree(proc.pid)
                if not n.alive and w["dead"] is None:
                    w["dead"] = time.time()
            stop.wait(0.05)

    watcher = threading.Thread(target=watch, daemon=True)
    card_pids = set()
    try:
        rt.init(_existing_node=head)
        if rt.cluster_resources().get("GPU", 0) != 0:
            raise SystemExit("autoscaler: the head advertises a card")
        asc.start()
        watcher.start()
        config = dataclasses.replace(data_processor_config(), concurrency=1,
                                     num_gpus=1)
        genuine = batch_mod._EngineUDF
        batch_mod._EngineUDF = autoscaler_engine_udf()
        try:
            ds = batch_mod.build_llm_processor(config)(data.read_mongo(
                f"mongodb://127.0.0.1:{port}", "smoke", "prompts",
                override_num_blocks=AUTOSCALER_BLOCKS))
        finally:
            batch_mod._EngineUDF = genuine
        t0 = time.time()
        box = {}
        reader = threading.Thread(
            target=lambda: box.update(rows=ds.take_all()), daemon=True)
        reader.start()
        while not seen:  # no fallback: the engine runs on a launched node
            if time.time() - t0 > AUTOSCALER_JOIN_S:
                raise SystemExit(f"autoscaler: no node joined within "
                                 f"{AUTOSCALER_JOIN_S} s of take_all")
            time.sleep(0.05)
        reader.join(AUTOSCALER_TIMEOUT_S)
        if "rows" not in box:
            raise SystemExit(f"autoscaler: no rows after "
                             f"{AUTOSCALER_TIMEOUT_S} s; nodes seen {seen}")
        rows = box["rows"]
        wall = time.time() - t0
        if len(created) != 1 or len(seen) != 1:
            raise SystemExit(f"autoscaler: launched {len(created)} nodes, "
                             f"{len(seen)} joined the GCS")
        (nid, ntype, nres, launched_at), = created
        node = seen[nid]
        deadline = time.monotonic() + AUTOSCALER_END_S
        while node["dead"] is None:
            if time.monotonic() > deadline:
                raise SystemExit(f"autoscaler: the idle node was not "
                                 f"terminated within {AUTOSCALER_END_S} s")
            time.sleep(0.05)
        terminated_at = node["dead"]
        card_pids = set(node["procs"])
        res["exit_wait_s"] = wait_exited(card_pids, "autoscaler")
    finally:
        stop.set()
        srv.close()
        rt.shutdown()
        asc.shutdown()
    pids = sorted({int(r["pid"]) for r in rows})
    nodes = sorted({str(r["node"]) for r in rows})
    batches = {}
    for r in rows:
        batches.setdefault((int(r["pid"]), float(r["start"])), []).append(r)
    launches = sum(int(b[0]["launches_after"]) - int(b[0]["launches_before"])
                   for b in batches.values())
    n_tok = sum(len(r["generated_tokens"]) for r in rows)
    last = max(float(r["end"]) for r in rows)
    first = min(float(r["start"]) for r in rows)
    span = last - first
    engine_rate = report["engine"]["output_tok_s"]
    # the read tasks' range finds (the plan's two finds carry a sort)
    reads = [t - t0 for t, c in commands if "find" in c and "sort" not in c]
    res.update({
        "rows": len(rows), "tokens": n_tok, "batches": len(batches),
        "node_type": ntype, "node_resources": nres, "pids": pids,
        "node_processes": len(card_pids), "launches": launches,
        "cuda": sorted({bool(r["cuda"]) for r in rows}),
        "launch_s": launched_at - t0, "join_s": node["joined"] - t0,
        "actor_ready_s": max(float(r["ready_at"]) for r in rows) - t0,
        "first_batch_s": first - t0, "last_row_s": last - t0,
        "reads_s": [min(reads), max(reads)] if reads else None,
        "wall_s": wall,
        "tok_s_span": n_tok / span, "span_s": span,
        "engine_tok_s": engine_rate, "terminated_after_s":
        terminated_at - last})
    print(f"autoscaler: 1 node launched ({ntype} {nres}) "
          f"{res['launch_s']:.2f} s after take_all, joined at "
          f"{res['join_s']:.2f} s, the engine actor (pid {pids}, this "
          f"process {os.getpid()}) ready at {res['actor_ready_s']:.2f} s, "
          f"the read tasks' finds at {res['reads_s']} s, the first batch "
          f"at {res['first_batch_s']:.2f} s, the last of {len(rows)} rows "
          f"at {res['last_row_s']:.2f} s; "
          f"{n_tok} tokens in {len(batches)} batches, {n_tok / span:.1f} "
          f"output tok/s over the batches' span ({span:.3f} s) = "
          f"{n_tok / span / engine_rate:.4f} of run_engine's "
          f"{engine_rate:.1f}; the node terminated "
          f"{res['terminated_after_s']:.2f} s after the last row, its "
          f"{len(card_pids)} processes exited {res['exit_wait_s']:.2f} s "
          f"later; forward launches in the actor's process {launches}",
          flush=True)
    got = {str(r["_id"]): str(r["prompt"]) for r in rows}
    short = [len(r["generated_tokens"]) for r in rows
             if len(r["generated_tokens"]) != DATA_MAX_TOKENS]
    if len(rows) != AUTOSCALER_DOCS or got != want or short:
        raise SystemExit(f"autoscaler: {len(rows)} rows, prompts equal to "
                         f"the documents' {got == want}, short {short}")
    if (len(pids) != 1 or os.getpid() in pids or pids[0] not in card_pids
            or nodes != [nid.hex()]):
        raise SystemExit(f"autoscaler: the actor ran in {pids} on nodes "
                         f"{nodes}, not in the launched node "
                         f"{nid.hex()} ({sorted(card_pids)})")
    if res["cuda"] != [True] or launches <= 0:
        raise SystemExit(f"autoscaler: CUDA {res['cuda']}, forward "
                         f"launches {launches}")
    differ = data_reference_ids(rows)
    res["ids_differ"] = differ
    res["phase_s"] = time.monotonic() - t_phase
    report["autoscaler"] = res
    print(f"autoscaler: rows whose ids differ from this process's "
          f"_EngineUDF on the same batches in the actor's order: {differ} "
          f"of {len(rows)}; phase {res['phase_s']:.1f} s", flush=True)
    if differ:
        raise SystemExit(f"autoscaler: {differ} rows' ids differ from this "
                         f"process's engine")
    return launches


OBS_TIMEOUT_S = 360  # the child's whole run; it takes ~25 s on the CPU


CHECK_TIMEOUT_S = 120
CHECK_PASSES = 6


def run_check(report):
    """The port's static checker on the card's host (phase 0, before any
    card work): ``ray_tpu_torch._private.staticcheck``'s ``main`` with
    ``--json`` in a child process, which then prints the heavy modules it
    holds.  Prints the violations, allowlisted findings and passes, and
    the child's wall and CPU time (user + sys, from
    ``getrusage(RUSAGE_CHILDREN)``: this process runs no other child
    meanwhile).  Fails unless the child exits 0 with ``ok`` true, all six
    passes ran, and neither torch nor JAX is in its ``sys.modules``."""
    import resource

    code = ("import json, sys\n"
            "from ray_tpu_torch._private import staticcheck\n"
            "rc = staticcheck.main(['--json'])\n"
            "print(json.dumps(sorted(m for m in ('torch', 'jax')\n"
            "                        if m in sys.modules)))\n"
            "sys.exit(rc)\n")
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE,
                          capture_output=True, text=True,
                          timeout=CHECK_TIMEOUT_S,
                          env=dict(os.environ, PYTHONPATH=HERE))
    wall = time.monotonic() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime
                                                - before.ru_stime)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "check.json"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"rtpu check exited {proc.returncode}: "
                         f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    doc_text, _, modules_line = proc.stdout.rstrip().rpartition("\n")
    doc, modules = json.loads(doc_text), json.loads(modules_line)
    violations = [f for f in doc["findings"] if not f["allowlisted"]]
    allowlisted = len(doc["findings"]) - len(violations)
    print(f"check: {len(violations)} violation(s), {allowlisted} "
          f"allowlisted, {len(doc['passes'])} pass(es) "
          f"({', '.join(doc['passes'])}); child {wall:.2f} s wall, "
          f"{cpu:.2f} s CPU (the checker's own elapsed "
          f"{doc['elapsed_s']:.3f} s); modules held: {modules or 'none'}",
          flush=True)
    report["check"] = {"violations": len(violations),
                       "allowlisted": allowlisted, "passes": doc["passes"],
                       "unused_allows": len(doc["unused_allows"]),
                       "wall_s": wall, "cpu_s": cpu,
                       "elapsed_s": doc["elapsed_s"], "modules": modules}
    if not doc["ok"] or violations:
        raise SystemExit(f"rtpu check found violations: {violations}")
    if len(doc["passes"]) != CHECK_PASSES:
        raise SystemExit(f"rtpu check ran {doc['passes']}")
    if modules:
        raise SystemExit(f"rtpu check imported {modules}")


def relay_child(argv, tag: str, log_name: str, timeout_s: float,
                env_extra: dict = None):
    """Run ``python <argv>`` from the checkout's root in a session of its
    own, its output relayed line by line under ``tag`` and written to
    ``chiprun_out/<log_name>``; the session is killed when the child ends
    or times out (it holds the child's cluster's workers too).  Returns
    the exit code (None on a timeout) and the output's lines."""
    import threading

    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p and p != HERE])
    proc = subprocess.Popen(
        [sys.executable, *argv], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []

    def relay():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            print(f"{tag}: {lines[-1]}", flush=True)

    reader = threading.Thread(target=relay, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        proc.wait()
        reader.join(10)
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write("\n".join(lines) + "\n")
    return rc, lines


def run_observability(report):
    """The observability plane on the card (after ``run_data``): the
    port's ``python -m ray_tpu_torch.scripts.obs_smoke`` in a child process
    whose fresh cluster starts with ``obs_smoke.SMOKE_ENV`` (its SLO rules,
    sampler cadence and metrics flush), its sections' lines passed through
    and its readings read back from its report.  Fails when the child
    fails, when the dashboard did not start, when the traced request's
    tree is not one ``serving-anatomy`` tree holding the serving spans,
    when ``smoke_ttft`` did not fire with an exemplar or ``smoke_queue``
    did not fire and clear, when the replica launched the forward kernel
    fewer than once a layer for the traced prefill, or when the replica's
    warmup ids differ from the in-process engine's.  Returns the forward
    kernel's launches on the phase's path (the in-process engine's and
    the replica's)."""
    from ray_tpu_torch.scripts import obs_smoke

    t_phase = time.monotonic()
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "obs_smoke.json")
    if os.path.exists(path):
        os.remove(path)
    rc, _ = relay_child(["-m", "ray_tpu_torch.scripts.obs_smoke",
                         "--report", path], "observability", "obs_smoke.log",
                        OBS_TIMEOUT_S, obs_smoke.SMOKE_ENV)
    if rc != 0:
        raise SystemExit(f"observability: obs_smoke exited {rc} (timeout "
                         f"{OBS_TIMEOUT_S} s); its output is in "
                         f"chiprun_out/obs_smoke.log")
    with open(path) as f:
        res = json.load(f)
    res["phase_s"] = time.monotonic() - t_phase
    report["observability"] = res
    anat, layers = res["anatomy"], res["model"]["n_layers"]
    gp = res["goodput"]
    card = card_line()
    print(f"observability: trace {res['trace']['spans']} spans over "
          f"{res['trace']['processes']} processes; the traced request's "
          f"tree {anat['spans']} spans over {anat['processes']} processes "
          f"({card})", flush=True)
    print(f"observability: traced TTFT {anat['ttft_ms']:.3f} ms, its "
          f"llm.prefill span {anat['prefill_ms']:.3f} ms ({card})",
          flush=True)
    print(f"observability: sampler tick p50 "
          f"{res['sampler']['tick_ms_p50']:.3f} ms, max "
          f"{res['sampler']['tick_ms_max']:.3f} ms over "
          f"{res['sampler']['ticks']} ticks; /metrics "
          f"{res['metrics']['lines']} lines, {res['metrics']['bytes']} "
          f"bytes ({card})", flush=True)
    print(f"observability: smoke_ttft fired {res['slo_ttft']['fire_s']:.2f}"
          f" s after the traced request began (verdict "
          f"{res['slo_ttft']['verdict']}); smoke_queue fired "
          f"{res['slo_queue']['fire_s']:.2f} s after the burst began and "
          f"cleared at {res['slo_queue']['clear_s']:.2f} s ({card})",
          flush=True)
    print(f"observability: goodput buckets "
          f"{ {k: round(v, 6) for k, v in gp['buckets'].items()} } over "
          f"{gp['elapsed_s']:.4f} s; MFU {gp['mfu']:.3e} of "
          f"{gp['peak_tflops']:.0f} TFLOP/s ({card})", flush=True)
    print(f"observability: the replica launched the forward kernel "
          f"{anat['traced_launches']} times for the traced prefill "
          f"({layers} layers), {anat['replica_launches']} in all; the "
          f"in-process engine {res['serving_metrics']['launches']}; phase "
          f"{res['phase_s']:.1f} s", flush=True)
    if not res.get("dashboard_url"):
        raise SystemExit("observability: the dashboard did not start")
    if not (obs_smoke.ANATOMY_SPANS <= set(anat["names"])):
        raise SystemExit(f"observability: the traced tree lacks "
                         f"{sorted(obs_smoke.ANATOMY_SPANS - set(anat['names']))}")
    if anat["traced_launches"] < layers:
        raise SystemExit(f"observability: the replica launched the forward "
                         f"kernel {anat['traced_launches']} times for the "
                         f"traced prefill, fewer than its {layers} layers")
    if anat["warmup_tokens"] != res["serving_metrics"]["tokens"][
            :len(anat["warmup_tokens"])]:
        raise SystemExit(f"observability: the replica's warmup ids "
                         f"{anat['warmup_tokens']} differ from the in-process "
                         f"engine's {res['serving_metrics']['tokens']}")
    return anat["replica_launches"] + res["serving_metrics"]["launches"]


# The port's runtime benchmarks, each through its entry point in a child
# process with a cluster (or store daemon) of its own: (label, argv,
# timeout s).  perf's record goes under chiprun_out/; none of them writes
# into the checkout.  For the script's time, store_bench runs 2 windows a
# metric (its default 4) and data_bench 256 images (its default 512): at
# the defaults the four took 143.9 s on an H100 machine's 8-core host.
CORE_BENCHES = (
    ("perf", ["-m", "ray_tpu_torch.scripts.cli", "microbenchmark",
              "--out", os.path.join(OUT_DIR, "core_bench.json")], 180),
    ("store_bench", ["-m", "ray_tpu_torch._private.store_bench",
                     "--reps", "2"], 150),
    ("data_bench", ["-m", "ray_tpu_torch._private.data_bench",
                    "--images", "256"], 150),
    ("scale_bench", ["-m", "ray_tpu_torch._private.scale_bench",
                     "--quick"], 180),
)
PERF_LABELS = (
    "single client tasks sync (batch 100)", "1:1 actor calls sync",
    "1:1 actor calls async (batch 50)",
    "n:n actor calls async (4 actors, batch 200)",
    "1:1 threaded actor calls async (batch 50)", "single client put (1KB)",
    "single client put (10MB)", "single client get <- plasma (10MB)",
    "multi client put (1KB, 4 clients)",
    "multi client put (10MB, 4 clients)")
STORE_BENCH_KEYS = (
    "single client put (1KB)", "single client get (1KB)",
    "single client put (10MB)", "single client get (10MB)",
    "multi client put (1KB, 4 clients)", "multi client get (1KB, 4 clients)",
    "multi client put (10MB, 4 clients)",
    "multi client get (10MB, 4 clients)")
# the pre-port records of the JAX package's benches, which the port's must
# never write
COMMITTED_BENCH_FILES = ("BENCH_core.json", "BENCH_data.json",
                         "BENCH_scale.json")


def json_lines(lines) -> dict:
    """The JSON objects a child printed on lines of their own, merged."""
    out = {}
    for line in lines:
        if line.startswith("{"):
            out.update(json.loads(line))
    return out


def file_digests(names) -> dict:
    import hashlib

    return {n: hashlib.sha256(open(os.path.join(HERE, n), "rb").read())
            .hexdigest() if os.path.exists(os.path.join(HERE, n)) else None
            for n in names}


def run_core_bench(report):
    """The port's runtime benchmarks on the card's host (after
    ``run_observability``): ``rtpu microbenchmark`` (perf's ten rates,
    its record written to ``chiprun_out/core_bench.json``), the store's
    data plane (``store_bench``), the data service at one and four splits
    against four private pipelines (``data_bench``) and the control
    plane's 1/50 envelope (``scale_bench --quick``), each in a child
    process of its own.  Fails when a child exits non-zero or times out,
    when a perf label or a store key is missing or not above 0, when
    ``shared_1`` hits no cache or ``shared_4`` fails over, when a scale
    invariant fails (tasks completed against submitted, actors alive
    against created, placement groups placed against asked), or when a
    committed ``BENCH_*.json`` changed.  No kernel runs here."""
    t_phase = time.monotonic()
    os.makedirs(OUT_DIR, exist_ok=True)
    record_path = os.path.join(OUT_DIR, "core_bench.json")
    if os.path.exists(record_path):
        os.remove(record_path)
    before = file_digests(COMMITTED_BENCH_FILES)
    res, out = {}, {}
    for label, argv, timeout_s in CORE_BENCHES:
        t0 = time.monotonic()
        rc, lines = relay_child(argv, f"core_bench {label}",
                                f"core_bench_{label}.log", timeout_s)
        if rc != 0:
            raise SystemExit(f"core_bench: {label} exited {rc} (timeout "
                             f"{timeout_s} s); its output is in "
                             f"chiprun_out/core_bench_{label}.log")
        res[f"{label}_s"] = time.monotonic() - t0
        out[label] = json_lines(lines)
    if file_digests(COMMITTED_BENCH_FILES) != before:
        raise SystemExit("core_bench: a committed BENCH_*.json changed")
    with open(record_path) as f:
        perf = json.load(f)
    rates = perf["results_per_s"]
    store = out["store_bench"]["store_bench"]
    data = out["data_bench"]["data_bench"]
    scale = out["scale_bench"]["scale_bench"]
    res.update(perf=perf, store=store,
               store_audit=out["store_bench"]["store_audit"], data=data,
               scale=scale)
    res["phase_s"] = time.monotonic() - t_phase
    report["core_bench"] = res
    card = card_line()
    for name in PERF_LABELS:
        print(f"core_bench perf: {name} {rates.get(name)} /s ({card})",
              flush=True)
    for name in STORE_BENCH_KEYS:
        print(f"core_bench store: {name} {store.get(name)} /s ({card})",
              flush=True)
    for name in ("independent_4", "shared_1", "shared_4"):
        print(f"core_bench data: {name} {data[name]} ({card})", flush=True)
    print(f"core_bench data: shared_4 / independent_4 "
          f"{data['shared_vs_independent_gain']} ({card})", flush=True)
    for name in ("tasks", "actors", "pgs_nodes"):
        print(f"core_bench scale: {name} {scale[name]} ({card})",
              flush=True)
    sync_us = 1e6 / rates["1:1 actor calls sync"]
    script_us = 1e3 * report["runtime"]["actor"]["noop_call_ms"]["p50"]
    res["actor_call_us"] = {"perf_sync": sync_us,
                            "run_runtime_noop_p50": script_us}
    print(f"core_bench: one sync actor call {sync_us:.1f} us in perf's "
          f"clean process, {script_us:.1f} us p50 for run_runtime's no-op "
          f"call in this process ({card})", flush=True)
    print(f"core_bench: phase {res['phase_s']:.1f} s (perf "
          f"{res['perf_s']:.1f}, store_bench {res['store_bench_s']:.1f}, "
          f"data_bench {res['data_bench_s']:.1f}, scale_bench "
          f"{res['scale_bench_s']:.1f})", flush=True)
    bad = [n for n in PERF_LABELS if not rates.get(n, 0) > 0]
    bad += [n for n in STORE_BENCH_KEYS if not store.get(n, 0) > 0]
    if bad:
        raise SystemExit(f"core_bench: missing or not above 0: {bad}")
    if not data["shared_1"]["cache_hits"] > 0:
        raise SystemExit("core_bench: shared_1 hit no cache")
    if data["shared_4"]["failovers"] != 0:
        raise SystemExit(f"core_bench: shared_4 failed over "
                         f"{data['shared_4']['failovers']} times")
    tasks, actors, pgs = scale["tasks"], scale["actors"], scale["pgs_nodes"]
    if tasks["completed"] != tasks["n_tasks"]:
        raise SystemExit(f"core_bench: {tasks['completed']} of "
                         f"{tasks['n_tasks']} tasks completed")
    if actors["alive"] != actors["n_actors"]:
        raise SystemExit(f"core_bench: {actors['alive']} of "
                         f"{actors['n_actors']} actors alive")
    if pgs["pgs_created"] != pgs["n_pgs"]:
        raise SystemExit(f"core_bench: {pgs['pgs_created']} of "
                         f"{pgs['n_pgs']} placement groups placed")


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

    # (e) where one step's device time goes (outside the counted run); a
    # window that lost one of the step's kernel events is profiled again
    want_profiled = {**{BF16_KERNELS[k]: n for k, n in want.items()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    rows = device_events(lambda: step(state, tokens),
                         complete=profiled_as(want_profiled))
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


def checkpoint_dir(need: int, label: str = "llama3") -> str:
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
            print(f"{label} checkpoint directory {path}: "
                  f"{free[path] / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
                  "needed", flush=True)
            return tempfile.mkdtemp(prefix=f"{label}_", dir=path)
    raise SystemExit(f"no directory has {need / 1e9:.1f} GB free for the "
                     f"{label} checkpoints: " + ", ".join(
                         f"{p} {b / 1e9:.1f} GB" for p, b in free.items()))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def run_llama3_trainer(report):
    """The Llama-3 8B pretraining recipe at Llama-3 8B's widths cut to four
    layers, batch 2 x seq 8192: (a) ``train_llama3_8b`` through
    ``DataParallelTrainer``, the controller and a worker actor of the
    port's runtime, its committed checkpoint and metrics, and a
    dry-geometry run whose checkpoint is restored onto the card (once the
    worker's process has left the card); (b) the same step in this
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

    import ray_tpu_torch as rt
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
        # (a) the entry point, its worker an actor of the port's runtime
        card_runtime()
        try:
            t0 = time.monotonic()
            result = train_llama3_8b(
                num_workers=1, steps=LLAMA3_STEPS, n_layers=LLAMA3_LAYERS,
                mesh={"fsdp": 1, "tp": 1},
                storage_path=os.path.join(tmp, "full"))
            fit_s = time.monotonic() - t0
            dry = train_llama3_8b(num_workers=1, dry_run=True, steps=2,
                                  ckpt_every=2, seq_len=64,
                                  storage_path=os.path.join(tmp, "dry"))
        finally:
            rt.shutdown()
        # the worker's process has left the card once its memory is free
        t0 = time.monotonic()
        while torch.cuda.mem_get_info()[0] < free - (1 << 30):
            if time.monotonic() - t0 > 60:
                raise SystemExit("llama3: the worker's process still holds "
                                 "the card after the runtime's shutdown")
            time.sleep(0.2)
        out["exit_wait_s"] = time.monotonic() - t0
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

    # where one step's device time goes (outside the counted run); a
    # window that lost one of the step's kernel events is profiled again
    want_profiled = {**{BF16_KERNELS[k]: n for k, n in want.items()},
                     **{k: 0 for k in SCALAR_KERNELS}}
    rows = device_events(lambda: step(state, tokens),
                         complete=profiled_as(want_profiled))
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
# Online RLlib (phase 13).  The card's machine has no gymnasium, so the
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
    """The recorded inputs of phase 13's update agreement: {name: (fn, its
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
# Offline RL and DreamerV3 (phase 13 (d), (e)): the expert of
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


# The thread runners' PPO readings on this card (PERF.md §5), which the
# runner actors' are printed beside: sample seconds an iteration and the
# iteration's env steps a second (1024 steps over 0.21-0.31 s)
THREAD_RUNNERS_SAMPLE_S = (0.138, 0.197)
THREAD_RUNNERS_STEPS_PER_S = (1024 / 0.31, 1024 / 0.21)


def probed_runner(base):
    """A subclass of the runner class ``base`` that reports, through its
    ``probe`` method, its process's pid, whether that process made a CUDA
    context, and the devices of everything its forward saw: the
    parameters it was handed, and in the single-agent and multi-agent
    runners the observations and generator of every ``module.action_dist``
    and ``module.forward`` call (the actor's process is its own, so the
    wrappers see only this runner), in DreamerV3's its (h, z) state."""

    class Probed(base):
        def __init__(self, *args, **kwargs):
            import torch

            from ray_tpu_torch.rllib import module
            from ray_tpu_torch.train.step import tree_leaves

            super().__init__(*args, **kwargs)
            seen = self._probe_devices = set()

            def recording(fn):
                def call(params, obs, *rest, **kw):
                    seen.update({obs.device.type, *(
                        t.device.type for t in tree_leaves(params))})
                    seen.update(r.device.type for r in rest
                                if isinstance(r, torch.Generator))
                    return fn(params, obs, *rest, **kw)
                return call

            module.action_dist = recording(module.action_dist)
            module.forward = recording(module.forward)

        def _saw(self, params):
            from ray_tpu_torch.train.step import tree_leaves

            self._probe_devices.update(t.device.type
                                       for t in tree_leaves(params))
            for state in ("_h", "_z"):
                if hasattr(self, state):
                    self._probe_devices.add(getattr(self, state).device.type)

        def sample(self, params, *args, **kwargs):
            out = super().sample(params, *args, **kwargs)
            self._saw(params)
            return out

        def sample_transitions(self, params, *args, **kwargs):
            out = super().sample_transitions(params, *args, **kwargs)
            self._saw(params)
            return out

        def probe(self):
            import torch

            return {"pid": os.getpid(),
                    "cuda_initialized": torch.cuda.is_initialized(),
                    "forward_devices": sorted(self._probe_devices)}

    Probed.__name__ = Probed.__qualname__ = f"Probed{base.__name__}"
    return Probed


class probed_runners:
    """Within the block, every online algorithm builds its env runners
    from ``probed_runner`` subclasses (the algorithms look their runner
    class up in their module when they are built)."""

    def __enter__(self):
        from ray_tpu_torch.rllib import (dqn, dreamerv3, impala, multi_agent,
                                         ppo, sac)

        self._saved = [(m, n, getattr(m, n)) for m, n in (
            (ppo, "EnvRunner"), (impala, "EnvRunner"), (dqn, "EnvRunner"),
            (sac, "EnvRunner"), (multi_agent, "MultiAgentEnvRunner"),
            (dreamerv3, "DreamerEnvRunner"))]
        for m, n, cls in self._saved:
            setattr(m, n, probed_runner(cls))
        return self

    def __exit__(self, *exc):
        for m, n, cls in self._saved:
            setattr(m, n, cls)
        return False


def runner_probes(name, algo):
    """Every runner actor's ``probe``; fails unless each runs in a process
    of its own, made no CUDA context, and computed its forward on the CPU
    only."""
    import ray_tpu_torch as rt

    runners = getattr(algo, "runners", None) or algo._runners
    probes = rt.get([r.probe.remote() for r in runners], timeout=60)
    pids = {p["pid"] for p in probes}
    print(f"rllib {name}: {len(probes)} runner actors, pids {sorted(pids)} "
          f"(this process {os.getpid()}), CUDA context in any "
          f"{any(p['cuda_initialized'] for p in probes)}, their forward on "
          f"{sorted({d for p in probes for d in p['forward_devices']})}",
          flush=True)
    if (os.getpid() in pids or len(pids) != len(probes)
            or any(p["cuda_initialized"] for p in probes)
            or any(p["forward_devices"] != ["cpu"] for p in probes)):
        raise SystemExit(f"rllib {name}: runner actors {probes}: want a "
                         f"process each, not this one, no CUDA context, "
                         f"the forward on the CPU only")
    return probes


def rl_learn(name, algo, iters, stop_at=None):
    """Train ``algo`` for ``iters`` iterations (fewer once the best return
    reaches ``stop_at``); returns (best return, last result, a row of
    timings and the runners' probes).  An update is one call of the
    algorithm's update function: ``learn_time_ms`` of an iteration over
    its updates."""
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
        probes = runner_probes(name, algo)
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
           "iterations_timed": len(per_update), "runners": probes}
    print(f"rllib {name}: best return {best:.2f} in {n_iters} iterations, "
          f"{steps} env steps at {row['env_steps_per_s']:.1f}/s, update ms "
          f"p50 {fmt_ms(row['update_ms_p50'])} over {len(per_update)} "
          f"iterations, {wall:.2f} s", flush=True)
    return best, result, row


def run_rllib(report):
    """Phase 11: online RLlib with the learners on the card and the env
    runners actors of the port's runtime, their forward on the CPU."""
    import ray_tpu_torch as rt

    t_phase = time.monotonic()
    report["rllib"] = {}
    rl_update_agreement(report, "cuda")
    node = card_runtime()
    try:
        with probed_runners():
            rl_online(report)
    finally:
        rt.shutdown()
    report["rllib"]["session"] = node.session_dir
    report["rllib"]["phase_s"] = time.monotonic() - t_phase
    print(f"rllib phase: {report['rllib']['phase_s']:.1f} s", flush=True)
    failed = [k for k, (ok, _) in report["rllib"].pop("gates").items()
              if not ok]
    if failed:
        raise SystemExit(f"RL learning gates failed: {failed}")


def rl_build_all(builders):
    """Call every builder at once, each on a thread of its own, so the
    runner actors' processes start side by side.  Returns ({name: built
    algorithm}, {name: its build's seconds}, the seconds until all were
    built); a failed build raises."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {k: pool.submit(timed, b) for k, b in builders.items()}
        built = {k: f.result() for k, f in futures.items()}
    wall = time.perf_counter() - t0
    each = {k: s for k, (_, s) in built.items()}
    print(f"rllib: {len(built)} online algorithms built at once in "
          f"{wall:.2f} s (each with its runner actors: "
          + ", ".join(f"{k} {t:.2f} s" for k, t in each.items()) + ")",
          flush=True)
    return {k: a for k, (a, _) in built.items()}, each, wall


def rl_parity_actor():
    """A PPO runner actor for ``rl_sample_parity`` (the runner class PPO
    builds its actors from, PPO's env, 4 envs, seed 3); started ahead so
    that its process's start overlaps PPO's runners'."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    return rt.remote(EnvRunner).remote(NumpyCartPole, 4, seed=3)


def rl_sample_parity(actor, params):
    """One ``sample`` call of ``actor`` (``rl_parity_actor``) against the
    same call on an ``EnvRunner`` in this process, built with the same
    env, seed and parameters: the fragments equal to the bit."""
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import module
    from ray_tpu_torch.rllib.env_runner import EnvRunner

    host = module.host_copy(params)
    local = EnvRunner(NumpyCartPole, 4, seed=3)
    try:
        got = rt.get(actor.sample.remote(rt.put(host), 128), timeout=60)
    finally:
        rt.kill(actor)
    want = local.sample(host, 128)
    equal = set(got) == set(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)
    print(f"rllib ppo: one sample of 128 steps x 4 envs from a runner actor "
          f"equals this process's EnvRunner's (same seed, env, parameters) "
          f"to the bit: {equal}", flush=True)
    if not equal:
        raise SystemExit("a runner actor's sample differs from this "
                         "process's EnvRunner's")
    return equal


def rl_online(report):
    """Phase 11 (b)-(e) on the runtime ``run_rllib`` started."""
    import torch

    from ray_tpu_torch.rllib import module, ppo
    from ray_tpu_torch.rllib.appo import APPOConfig
    from ray_tpu_torch.rllib.dqn import DQNConfig
    from ray_tpu_torch.rllib.examples import TargetMatchEnv
    from ray_tpu_torch.rllib.impala import IMPALAConfig
    from ray_tpu_torch.rllib.multi_agent import MultiAgentPPOConfig
    from ray_tpu_torch.rllib.sac import SACConfig
    from ray_tpu_torch.train.step import tree_leaves

    from ray_tpu_torch.rllib.examples import OneHotBanditEnv

    # every online algorithm at its JAX test's configuration, built at
    # once: the runner actors' processes (and the parity check's) start
    # side by side; each is then trained alone
    parity = rl_parity_actor()
    algos, build_s, builds_wall = rl_build_all({
        "ppo": lambda: ppo.PPOConfig().environment(NumpyCartPole)
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=128)
        .training(lr=3e-3, num_epochs=6, minibatch_size=256,
                  entropy_coeff=0.01, seed=3).build(),
        "appo": lambda: APPOConfig(
            num_env_runners=2, num_envs_per_runner=2,
            rollout_fragment_length=64, lr=5e-3, minibatch_size=128, seed=0,
            env=NumpyCartPole).build(),
        "impala": lambda: IMPALAConfig(
            num_env_runners=2, num_envs_per_runner=4,
            rollout_fragment_length=64, lr=7e-4, entropy_coeff=0.02, seed=1,
            env=NumpyCartPole).build(),
        "dqn": lambda: DQNConfig(
            num_env_runners=2, num_envs_per_runner=2,
            rollout_fragment_length=64, learning_starts=256,
            train_batch_size=64, num_updates_per_iter=8,
            target_network_update_freq=300, epsilon_decay_steps=2500, seed=3,
            env=NumpyCartPole).build(),
        "sac": lambda: SACConfig(
            num_env_runners=2, num_envs_per_runner=2,
            rollout_fragment_length=64, learning_starts=256,
            train_batch_size=128, num_updates_per_iter=24, seed=0,
            env=NumpyCartPole).build(),
        "multi_agent_ppo": lambda: MultiAgentPPOConfig(
            env=TargetMatchEnv, policy_mapping_fn=lambda a: f"p_{a}",
            num_env_runners=1, rollout_fragment_length=128, seed=0, lr=5e-3,
            num_epochs=6).build(),
        "dreamerv3": lambda: dreamer_config(OneHotBanditEnv).build()})
    report["rllib"]["builds"] = {"wall_s": builds_wall, "each_s": build_s}

    # (b) PPO at tests/test_rllib.py's configuration
    algo = algos["ppo"]
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
    probes = runner_probes("ppo", algo)
    learner_devices |= {t.device.type for t in tree_leaves(algo.params)}
    forward_devices = {d for p in probes for d in p["forward_devices"]}
    last = result["episode_return_mean"]
    ok_ppo = (result["training_iteration"] == 12
              and result["timesteps_total"] == 12 * 2 * 4 * 128
              and last > max(60.0, (first or 0) * 1.5))
    sample_s = sorted(it["sample_s"] for it in iters)
    steps_s = sorted(it["env_steps_per_s"] for it in iters)
    print(f"rllib ppo (tests/test_rllib.py's configuration, NumpyCartPole):"
          f" first {first}, last {last:.2f}, gate > "
          f"{max(60.0, (first or 0) * 1.5):.2f}; {result['timesteps_total']}"
          f" env steps in {ppo_wall:.2f} s; learner on {learner_devices}, "
          f"runners' forward on {forward_devices}", flush=True)
    print(f"rllib ppo runner actors: sample {sample_s[0]:.4f}-"
          f"{sample_s[-1]:.4f} s an iteration (median "
          f"{sample_s[len(sample_s) // 2]:.4f}), {steps_s[0]:.1f}-"
          f"{steps_s[-1]:.1f} env steps/s (median "
          f"{steps_s[len(steps_s) // 2]:.1f}); the thread runners on this "
          f"card: sample {THREAD_RUNNERS_SAMPLE_S[0]}-"
          f"{THREAD_RUNNERS_SAMPLE_S[1]} s, {THREAD_RUNNERS_STEPS_PER_S[0]:.1f}"
          f"-{THREAD_RUNNERS_STEPS_PER_S[1]:.1f} env steps/s", flush=True)
    rl_sample_parity(parity, algo.params)

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
        "iterations": iters,
        "learner_devices": sorted(learner_devices),
        "runner_forward_devices": sorted(forward_devices),
        "runners": probes, "sample_parity": True,
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
    algo = algos["appo"]
    inflight = []
    train = algo.train

    def appo_train():
        out = train()
        inflight.append(algo._inflight is not None)
        return out

    algo.train = appo_train
    best, _, row = rl_learn("appo", algo, 30, stop_at=60.0)
    gates["appo"] = (best >= 60.0 and all(inflight), row)

    best, result, row = rl_learn("impala", algos["impala"], 30)
    row["mean_rho"] = result.get("mean_rho")
    gates["impala"] = (best > 60 and result["loss"] is not None
                       and result["mean_rho"] > 0, row)

    best, result, row = rl_learn("dqn", algos["dqn"], 22)
    gates["dqn"] = (best > 60 and result["num_updates"] > 0
                    and result["loss"] is not None, row)

    best, result, row = rl_learn("sac", algos["sac"], 45, stop_at=50.0)
    row["alpha"] = result["alpha"]
    gates["sac"] = (best >= 50.0 and result["alpha"] > 0.0, row)

    best, result, row = rl_learn("multi_agent_ppo", algos["multi_agent_ppo"],
                                 15, stop_at=24.0)
    row["per_agent_return_mean"] = result["per_agent_return_mean"]
    gates["multi_agent_ppo"] = (
        best >= 24.0 and set(result["policies"]) == {"p_a0", "p_a1"}
        and min(result["per_agent_return_mean"].values()) >= 9.0, row)

    rl_offline(report, gates)
    rl_dreamer(report, gates, algos["dreamerv3"])

    report["rllib"]["algorithms"] = {k: row for k, (_, row) in gates.items()}
    report["rllib"]["gates"] = gates


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


def rl_dreamer(report, gates, algo):
    """Phase 11 (e): DreamerV3 at tests/test_dreamerv3.py's learning
    configuration and gate on OneHotBanditEnv (best return >= 10 within
    80 iterations, the world-model loss falling), the learner on the card
    and the runner's filtering state and forward on the CPU; then one
    ``_update`` under the profiler on copies of the learner's state."""
    from ray_tpu_torch.train.step import tree_leaves

    t0 = time.perf_counter()
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
        probes = runner_probes("dreamerv3", algo)
        runner_devices = {d for p in probes for d in p["forward_devices"]}
        profiled = dreamer_profile(algo)
    finally:
        algo.stop()
    per_update.sort()
    row = {"iterations": iters, "updates": result["num_updates"],
           "best_return": best, "wm_loss_first": wm[0] if wm else None,
           "wm_loss_last": wm[-1] if wm else None,
           "update_ms_p50": per_update[len(per_update) // 2],
           "env_steps": result["env_steps_sampled"], "learn_s": learn_s,
           "phase_s": time.perf_counter() - t0,
           "learner_devices": sorted(learner_devices),
           "runner_devices": sorted(runner_devices), "runners": probes,
           "profiled_update": profiled}
    print(f"rllib dreamerv3 (tests/test_dreamerv3.py's configuration, "
          f"OneHotBanditEnv): best return {best:.2f} in {iters} iterations "
          f"(gate >= 10 within 80), {row['updates']} updates, update ms p50 "
          f"{row['update_ms_p50']:.2f}, world-model loss "
          f"{row['wm_loss_first']} -> {row['wm_loss_last']}, "
          f"{row['env_steps']} env steps; learning {learn_s:.2f} s, phase "
          f"{row['phase_s']:.2f} s; learner on {sorted(learner_devices)}, "
          f"runner's state and forward on {sorted(runner_devices)}; host ms "
          f"per update {row['update_ms_p50']:.2f} (p50 over iterations), "
          f"{profiled['update_ms']:.2f} (one profiled update)", flush=True)
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
    t_script = time.monotonic()
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
    run_check(report)
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
    runtime_launches = run_runtime(report)
    frontend_launches = run_frontends(report)
    serve_launches = run_serve_bench(report)
    serve_runtime_launches = run_serve(report)
    trainer_launches = run_trainer(report)
    torch_trainer_launches = run_torch_trainer(report)
    tune_launches = run_tune(report)
    plane_launches = run_actor_plane(report)
    data_launches = run_data(report)
    autoscaler_launches = run_autoscaler(report)
    obs_launches = run_observability(report)
    run_core_bench(report)
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
                   "tune": tune_launches[name],
                   "actor_plane": plane_launches[name],
                   "data": data_launches[name],
                   "moe_trainer": moe_launches[name],
                   "llama3_trainer": llama3_launches[name]}
        if name == "flash_fwd":
            by_path = {"engine": engine_launches,
                       "runtime": runtime_launches,
                       "frontends": frontend_launches,
                       "serve_bench": serve_launches,
                       "serve": serve_runtime_launches,
                       "autoscaler": autoscaler_launches,
                       "observability": obs_launches, **by_path}
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
    report["script_s"] = time.monotonic() - t_script
    print(f"script: {report['script_s']:.1f} s", flush=True)
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
