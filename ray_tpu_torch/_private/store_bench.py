"""Standalone object-store data-plane benchmark.

Counterpart of ``ray_tpu/_private/store_bench.py`` on the port's store.
Measures raw ``StoreClient`` put/get throughput at 1KB and 10MB, one
client and N concurrent client processes, against one private store
daemon: no scheduler, actors or serialization in the loop, so the numbers
isolate the data plane itself (the full-stack equivalents are
``perf.py``'s, whose labels these keys mirror).

Run: ``python -m ray_tpu_torch._private.store_bench``.  Prints one JSON
line: ``{"store_bench": {<label>: ops_per_s, ...}, "store_audit": {...}}``.

Method as in perf.py: best of ``--reps`` windows (on a shared host a
single window regularly reads low), and the multi-client aggregate is
total ops / the driver's wall clock for the whole round, never a sum of
per-client rates over skewed busy windows.  Payloads are ``np.zeros``, as
in Ray's microbenchmark.  Put loops rely on the daemon's LRU eviction to
recycle capacity (no delete round trip rides the measured path); get
loops read one pre-sealed object.  The client processes are spawned:
they import numpy and the store client, and never torch.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
import time

# The zero-copy plane's puts land in a pre-faulted mapping: fault the
# whole bench segment so the numbers measure steady state, not
# first-touch page faults.  setdefault: an explicit operator value still
# wins.  Must happen before store_client is imported (it reads the knob at
# import).
#
# The segment is deliberately small: put loops rely on LRU eviction to
# recycle space (no delete round trip on the measured path), and a
# compact segment keeps the recycled extents cache- and TLB-resident —
# the same locality a steady-state producer sees when the store daemon
# hands freed extents back out.
_CAPACITY = 96 << 20

os.environ.setdefault("RTPU_PREFAULT_BYTES", str(_CAPACITY))

import numpy as np  # noqa: E402

from ray_tpu_torch.core.store_client import (  # noqa: E402
    StoreClient,
    StoreServer,
)

_SIZES = (("1KB", 1024), ("10MB", 10 * 1024 * 1024))


def _oid(counter: int, salt: int = 0) -> bytes:
    return salt.to_bytes(4, "big") + counter.to_bytes(16, "big")


def _bench_window(fn, duration: float, reps: int) -> float:
    """Best-of-``reps`` ops/s over ``duration``-second windows."""
    fn()  # warm
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        count = 0
        while time.perf_counter() - t0 < duration:
            fn()
            count += 1
        best = max(best, count / (time.perf_counter() - t0))
    return best


def _put_loop(client: StoreClient, payload, salt: int):
    counter = [0]

    def put_one():
        counter[0] += 1
        client.put(_oid(counter[0], salt), payload)

    return put_one


def _get_loop(client: StoreClient, oid: bytes, size: int):
    def get_one():
        out = client.get_bytes(oid)
        if out is None or len(out) != size:
            raise RuntimeError("bench get missed a sealed object")
        if isinstance(out, memoryview):  # large objects come back pinned
            out.release()
            client.release(oid)

    return get_one


def _multi_worker(socket_path: str, shm_name: str, capacity: int,
                  mode: str, size: int, n_ops: int, salt: int,
                  barrier, done_q) -> None:
    failed = True
    try:
        client = StoreClient(socket_path, shm_name, capacity)
        payload = np.zeros(size, np.uint8)
        if mode == "put":
            op = _put_loop(client, payload, salt)
        else:
            oid = _oid(0, salt)
            client.put(oid, payload)
            op = _get_loop(client, oid, size)
        op()  # warm (faults, pool dial)
        failed = False
    finally:
        # reach the barrier even on setup failure: the driver must never
        # wait forever on a worker that died before the start line
        barrier.wait(timeout=120)
    if failed:
        sys.exit(1)
    for _ in range(n_ops):
        op()
    # perf_counter is CLOCK_MONOTONIC: comparable across processes, so
    # the driver can clock the round to the LAST op, not to process
    # exit (the children's interpreter teardown would otherwise ride the
    # measured window)
    done_q.put(time.perf_counter())
    client.close()


def _multi_round(srv: StoreServer, mode: str, size: int, clients: int,
                 n_ops: int, rounds: int, salt_base: int) -> float:
    """Aggregate ops/s: total ops / wall clock from release to last exit."""
    best = 0.0
    ctx = multiprocessing.get_context("spawn")
    for rnd in range(rounds):
        barrier = ctx.Barrier(clients + 1)
        done_q = ctx.Queue()
        procs = [
            ctx.Process(
                target=_multi_worker,
                args=(srv.socket_path, srv.shm_name, srv.capacity, mode,
                      size, n_ops, salt_base + clients * rnd + i, barrier,
                      done_q))
            for i in range(clients)
        ]
        for p in procs:
            p.start()
        barrier.wait(timeout=120)
        t0 = time.perf_counter()
        done = [done_q.get(timeout=120) for _ in procs]
        dur = max(done) - t0
        for p in procs:
            p.join()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"bench worker failed ({mode} {size}B)")
        best = max(best, clients * n_ops / dur)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client processes (default 4)")
    ap.add_argument("--duration", type=float, default=1.0,
                    help="single-client window seconds (default 1.0)")
    ap.add_argument("--reps", type=int, default=4,
                    help="windows/rounds per metric; best wins (default 4)")
    ap.add_argument("--capacity", type=int, default=_CAPACITY,
                    help="store segment bytes (default 96MiB)")
    args = ap.parse_args(argv)

    tmp = tempfile.TemporaryDirectory(prefix="rtpt_store_bench_")
    srv = StoreServer(os.path.join(tmp.name, "store.sock"),
                      f"rtpt_bench_{os.getpid()}", args.capacity)
    results = {}
    try:
        client = StoreClient(srv.socket_path, srv.shm_name, srv.capacity)
        for idx, (label, size) in enumerate(_SIZES):
            payload = np.zeros(size, np.uint8)
            print(f"running: single client {label}", file=sys.stderr)
            rate = _bench_window(_put_loop(client, payload,
                                           salt=2 * idx + 1),
                                 args.duration, args.reps)
            results[f"single client put ({label})"] = round(rate, 1)
            oid = _oid(0, salt=2 * idx + 2)
            client.put(oid, payload)
            rate = _bench_window(_get_loop(client, oid, size),
                                 args.duration, args.reps)
            results[f"single client get ({label})"] = round(rate, 1)
        client.close()

        # Per-client op counts sized so a round runs long enough to
        # amortize scheduler skew but stays a few seconds at seed rates.
        # Salt bases keep every phase's object ids disjoint (a put bench
        # must never collide with an earlier phase's sealed objects).
        salt_base = 1000
        for label, size in _SIZES:
            n_ops = 400 if size <= 1024 else 100
            for mode in ("put", "get"):
                key = f"multi client {mode} ({label}, {args.clients} clients)"
                print(f"running: {key}", file=sys.stderr)
                rate = _multi_round(srv, mode, size, args.clients, n_ops,
                                    args.reps, salt_base)
                results[key] = round(rate, 1)
                salt_base += 1000
        # End-of-run store audit (summary only, off the measured path):
        # records what the bench left the segment looking like, so a
        # perf regression can be correlated with occupancy/fragmentation
        # drift between rounds.
        aud_client = StoreClient(srv.socket_path, srv.shm_name,
                                 srv.capacity)
        s = aud_client.audit(max_rows=0, max_tombstones=0)["summary"]
        audit = {k: s.get(k) for k in
                 ("capacity", "used", "num_objects", "free_blocks",
                  "largest_free", "evictions", "spills")}
        audit["occupancy"] = round(s.get("occupancy", 0.0), 4)
        audit["fragmentation"] = round(s.get("fragmentation", 0.0), 4)
        aud_client.close()
    finally:
        srv.shutdown()
        tmp.cleanup()

    for name, rate in results.items():
        print(f"{name:48s} {rate:12.1f} /s", file=sys.stderr)
    print(f"store audit after run: occ={audit['occupancy']:.1%} "
          f"frag={audit['fragmentation']:.1%} "
          f"evictions={audit['evictions']}", file=sys.stderr)
    print(json.dumps({"store_bench": results, "store_audit": audit}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
