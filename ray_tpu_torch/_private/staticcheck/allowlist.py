"""Reviewed findings that stay in the port's tree on purpose.

Every entry MUST carry a reason string explaining why the finding is
acceptable: ``rtpu check`` fails on an entry with an empty reason, and
prints a note for entries that no longer match anything (so stale
suppressions get pruned instead of accreting).
"""

from __future__ import annotations

from ray_tpu_torch._private.staticcheck.common import Allow

ALLOWLIST: list[Allow] = [
    # -- locks: the native daemons are the JAX package's, byte for byte ----
    Allow("locks/blocking-under-mutex", "ray_tpu_torch/native/core_worker.cc",
          "send_all() while holding send_mu",
          reason="send_mu exists to serialize frame writers on one "
                 "connection fd; holding it across send_all is the design "
                 "(one mutex per connection, its contenders are the other "
                 "submitters on that channel; a hand-off queue would add a "
                 "copy and a thread)."),
    Allow("locks/blocking-under-mutex", "ray_tpu_torch/native/shm_store.cc",
          "while holding mu_",
          reason="spill and restore disk IO run under the store mutex on "
                 "purpose (SpillLocked's comment): eviction and restore are "
                 "the slow path, and serializing them keeps spill, create "
                 "and restore races correct, since extent reuse must be "
                 "atomic with the spill that frees it."),
    # -- purity: host syncs on paths that are not a training step ---------
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/train/checkpoint.py",
          ".item()",
          reason="load_pytree turns the restored 0-dim holders of a "
                 "checkpoint's Python numbers back into ints and floats: "
                 "a restore at start-up on CPU tensors, outside any step."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/train/gbdt.py",
          "np.asarray",
          reason="CPU-only dataset assembly from Python row dicts at "
                 "training setup; the GBDT path holds no device tensors, so "
                 "this is a host copy, not a sync."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/batch.py",
          "np.asarray",
          reason="packs the engine's generated token lists (Python ints) "
                 "into the output batch; nothing device-resident is "
                 "involved."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/engine.py",
          "np.asarray",
          reason="builds page-table rows from the scheduler's host-side "
                 "page lists (Python ints) before they go to the card; a "
                 "host copy, not a sync."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/engine.py",
          "() outside",
          reason="the engine samples on the host by design: pulling a "
                 "prefill's logits, a decode step's logits or a burst's "
                 "tokens to numpy is its one designed sync per step, timed "
                 "by the engine's own step accounting (serving, not a "
                 "GoodputTracker step)."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/kv_tier.py",
          "() outside",
          reason="encodes a sealed KV page to KVT1 bytes for the tier: "
                 "serialization at seal or handoff time, off the decode "
                 "loop, whose output must live on the host."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/model.py",
          ".cpu()",
          reason="gather_pages copies a request's pages to the host for "
                 "KV-tier sealing and P/D handoff; the copy is the point, "
                 "and it runs after the request's last step."),
    Allow("purity/host-sync-unbracketed", "ray_tpu_torch/llm/paged_cache.py",
          "np.asarray",
          reason="hashes host-side token lists (Python ints) into "
                 "prefix-cache keys; a host copy, not a device sync."),
    # -- shard ------------------------------------------------------------
    Allow("shard/dead-logical-axis", "ray_tpu_torch/parallel/sharding.py",
          "rule 'stage'",
          reason="'stage' is the logical spelling of the leading dim "
                 "that split_stages gives a caller's stacked layers, mapped "
                 "onto pp as in the JAX package's DEFAULT_RULES (the two "
                 "tables stay equal); no in-tree model spec is pipeline-"
                 "staged, so only callers' specs name it."),
    Allow("shard/comm-axis-unmodeled", "ray_tpu_torch/parallel/sharding.py",
          "mesh axis 'ep'",
          reason="expert parallelism moves tokens all-to-all, not by the "
                 "ring collectives comm.estimate_train_comm models; "
                 "comm.py's docstring leaves 'ep' out until the estimator "
                 "has an all-to-all term."),
    Allow("shard/comm-axis-unmodeled", "ray_tpu_torch/parallel/sharding.py",
          "mesh axis 'pp'",
          reason="pipeline stages exchange activations point to point "
                 "(collectives.rotate), not by ring collectives; comm.py "
                 "documents 'pp' as outside the estimator's model."),
    # -- proto ------------------------------------------------------------
    Allow("proto/opcode-uncalled",
          "ray_tpu_torch/_private/wire_constants.py",
          "XFER_PULL is dispatched",
          reason="compatibility with peers that predate XFER_PULL_RANGE "
                 "striping: the daemon keeps the plain-pull case while the "
                 "clients always send ranged pulls (the JAX package keeps "
                 "it for the same reason)."),
    Allow("proto/chaos-lane-off", "ray_tpu_torch/_private/direct.py",
          "RTPU_TESTING_RPC_FAILURE",
          reason="RPC chaos injects at the Python frame layer, which the "
                 "C++ transport bypasses, so direct.py switches the native "
                 "lane off for the flag to bite at all, as the JAX package "
                 "does; native-lane chaos hooks wait for the C++ "
                 "submission path (ROADMAP)."),
    # -- metrics: families read through the registry or by prefix ---------
    # family-unconsumed sees only literal name mentions.  The port spells
    # its families as a prefix plus a suffix and its tests read them from
    # the registry or rebuild the names, so the literal scan misses those
    # uses; every family also rides /metrics, rtpu top and /api/timeseries,
    # which enumerate families.  Entries are scoped by name prefix.
    Allow("metrics/family-unconsumed", "ray_tpu_torch/llm/engine.py", "'llm_",
          reason="tests/test_torch_engine_observability.py holds every "
                 "engine family to the JAX engine's through the registry "
                 "(same names, kinds and per-request moves); rtpu top and "
                 "ad-hoc SLO rules read them on the dynamic surfaces."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/_private/profiling.py",
          "'cuda_",
          reason="chip_smoke.py's serving and observability phases and "
                 "tests/test_torch_runtime.py read the device-memory and "
                 "kernel-build series through _DeviceTelemetry's name "
                 "constants, not by literal name."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/data/executor.py",
          "'data_op_",
          reason="tests/test_torch_data.py rebuilds these names as the "
                 "prefix plus METRIC_SUFFIXES and reads them from the "
                 "registry after a pipeline runs; rtpu top splits them by "
                 "operator tag."),
    Allow("metrics/family-unconsumed",
          "ray_tpu_torch/_private/data_service.py", "'data_job_",
          reason="per-job cache, failover and worker series are tagged by "
                 "job name and read through rtpu top's by-tag rate "
                 "splits; a literal-name consumer would hardcode one job."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/_private/scheduler.py",
          "'scheduler_",
          reason="scheduler depth, dispatch and spill counters back rtpu "
                 "top; tests/test_torch_runtime.py holds the runtime's "
                 "families to the JAX runtime's through the registry."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/core/store_client.py",
          "'store_",
          reason="store dataplane counters (puts, gets, transfer bytes "
                 "and latency, reconnects) feed rtpu top rate rows and the "
                 "store benchmarks; healthy thresholds depend on the "
                 "workload, so no fixed rule names them."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/_private/node.py",
          "'store_daemon_restarts_total'",
          reason="the restart signal's judged surface is the event plane "
                 "(store.daemon_restart events); the counter is the "
                 "scrapeable shadow for an external Prometheus alert."),
    Allow("metrics/family-unconsumed",
          "ray_tpu_torch/_private/object_transfer.py", "'transfer_",
          reason="range-striping byte and latency series for rtpu top and "
                 "the transfer benchmarks; healthy values scale with "
                 "object sizes, so no fixed threshold exists."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/serve/replica.py",
          "'serve_",
          reason="replica-local latency and ongoing-request series feed "
                 "the autoscaler's queue probes and the /metrics scrape; "
                 "the serve SLO families of DEFAULT_RULES cover paging."),
    Allow("metrics/family-unconsumed",
          "ray_tpu_torch/serve/request_router/base.py", "'serve_",
          reason="router imbalance and prefix-hit series are diagnostics "
                 "for comparing routing policies (serve_bench and rtpu "
                 "top); their thresholds depend on the policy."),
    Allow("metrics/family-unconsumed", "ray_tpu_torch/util/goodput.py",
          "'train_",
          reason="step-anatomy shadows of the goodput report (compile "
                 "seconds, TFLOP/s, tokens/s, restarts); the judged "
                 "family is the goodput fraction a default rule names, "
                 "the rest back rtpu top's drill-down."),
]
