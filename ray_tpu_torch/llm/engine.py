"""Continuous-batching LLM engine on one GPU.

Counterpart of ``ray_tpu/llm/engine.py``: an admission queue and a slot
table in front of a per-bucket prefill and ONE batched decode step
(``llm/model.py``).  The scheduler thread admits waiting requests into free
slots while pages last (prefill, or a suffix prefill on a prefix-cache
hit), then advances every active slot one token per iteration (decode),
streaming tokens into per-request queues.  When every active request is
greedy and no admission could happen, it chains 8 decode steps on the
device and fetches their tokens in one host round trip.

Not here yet (later slices): Prometheus metrics, tracing spans, events,
the store-backed KV tier, prefill/decode disaggregation, the OpenAI server
and batch inference.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
import time
import traceback
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.llm import model as lm
from ray_tpu_torch.llm.paged_cache import (CacheConfig, PageAllocator,
                                           PrefixCache, init_cache)
from ray_tpu_torch.models.llama import LlamaConfig, cast_weights


@dataclass
class EngineConfig:
    max_slots: int = 8  # concurrent sequences in the decode batch
    num_pages: int = 512
    page_size: int = 16
    max_seq_len: int = 1024
    prefill_buckets: tuple = (32, 64, 128, 256, 512, 1024)

    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket "
                         f"{self.prefill_buckets[-1]}")


@dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    stop_token_ids: tuple = ()
    seed: Optional[int] = None


@dataclass
class _Request:
    request_id: str
    prompt_tokens: List[int]
    params: SamplingParams
    out_queue: queue_mod.Queue = field(default_factory=queue_mod.Queue)
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None  # monotonic ts of first emit
    emitted: int = 0  # tokens delivered to the caller
    # Tokens produced toward max_tokens, surviving preemption/resume: a
    # preempted request folds its generated tokens into the prompt, so
    # len(slot.generated) restarts from zero while `produced` does not.
    produced: int = 0
    preempts: int = 0


@dataclass
class _Slot:
    request: _Request
    pages: List[int]
    num_tokens: int  # tokens with KV in cache (prompt + generated)
    last_token: int
    generated: List[int] = field(default_factory=list)
    rng: Optional[np.random.Generator] = None


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class LLMEngine:
    """Single-process engine over one device.

    ``state`` is a Llama parameter tree (``models.llama.init`` or
    ``convert.llama_params_from_jax``); it is moved to ``device`` and its
    weights cast to ``model_cfg.dtype`` once (``cast_weights``).  Runs on
    CUDA unless ``device="cpu"``; raises where CUDA is missing."""

    def __init__(self, state: Dict, model_cfg: LlamaConfig,
                 cfg: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg or EngineConfig()
        self.model_cfg = model_cfg
        self.state = cast_weights(_to_device(state, self.device), model_cfg)
        ccfg = CacheConfig(
            n_layers=model_cfg.n_layers, n_kv_heads=model_cfg.n_kv_heads,
            head_dim=model_cfg.head_dim, num_pages=self.cfg.num_pages,
            page_size=self.cfg.page_size, dtype=model_cfg.dtype)
        self.cache_k, self.cache_v = init_cache(ccfg, self.device)
        self.allocator = PageAllocator(self.cfg.num_pages)
        # Prefix caching: finished sequences leave their full prompt pages
        # resident; later prompts sharing a page-aligned prefix skip that
        # prefill compute.  A pure index over pages — all page ownership
        # still flows through self.allocator.
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.cfg.page_size)
            if os.environ.get("RTPU_PREFIX_CACHE", "1").lower()
            not in ("0", "false") else None)
        self.max_pages_per_seq = -(-self.cfg.max_seq_len
                                   // self.cfg.page_size)
        self._waiting: queue_mod.Queue = queue_mod.Queue()
        # Single-writer design: _slots, the allocator, the caches and
        # _stats are mutated ONLY by the scheduler thread (_loop); other
        # threads submit through the thread-safe _waiting queue and read
        # counters via stats(), whose individual reads are GIL-atomic.
        self._slots: List[Optional[_Slot]] = [None] * self.cfg.max_slots
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats = {"prefills": 0, "decode_steps": 0,
                       "tokens_generated": 0, "preempted": 0,
                       "admitted": 0, "page_evictions": 0,
                       "prefill_tokens_saved": 0, "cow_copies": 0}
        # Hit-aware admission: under pool pressure prefer the waiting
        # request whose prefix is resident, but never once the head of the
        # queue has waited longer than this cap (seconds).
        self._admit_age_cap_s = float(
            os.environ.get("RTPU_ADMIT_AGE_CAP_S", "0.25") or 0.25)
        # recent queue waits (submit -> admission) and prefill times
        self._queue_waits: "deque[float]" = deque(maxlen=128)
        self._prefill_times: "deque[float]" = deque(maxlen=128)

    # ------------------------- public API ---------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def submit(self, prompt_tokens: List[int],
               params: Optional[SamplingParams] = None) -> _Request:
        params = params or SamplingParams()
        total = len(prompt_tokens) + params.max_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+max_tokens = {total} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        # Page 0 is the reserved null page, so only num_pages-1 are ever
        # allocatable: an infeasible request would otherwise sit at the
        # queue head forever, wedging the engine for everyone behind it.
        n_pages = -(-total // self.cfg.page_size)
        if n_pages > self.cfg.num_pages - 1:
            raise ValueError(
                f"request needs {n_pages} KV pages but the cache has only "
                f"{self.cfg.num_pages - 1} allocatable pages")
        req = _Request(request_id=uuid.uuid4().hex[:12],
                       prompt_tokens=list(prompt_tokens), params=params)
        self._waiting.put(req)
        return req

    def generate(self, prompt_tokens: List[int],
                 params: Optional[SamplingParams] = None,
                 timeout_s: float = 300.0) -> List[int]:
        """Blocking convenience: submit + drain to completion."""
        self.start()
        req = self.submit(prompt_tokens, params)
        out: List[int] = []
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"generation {req.request_id} timed out")
            item = req.out_queue.get(timeout=remaining)
            if item is None:
                return out
            if isinstance(item, Exception):
                raise item
            out.append(item)

    def stats(self) -> dict:
        active = sum(s is not None for s in self._slots)

        def _pctile(ring, frac):
            # the scheduler thread appends concurrently; a mid-iteration
            # append at maxlen pops the head and invalidates the iterator
            for _ in range(4):
                try:
                    xs = sorted(ring)
                    break
                except RuntimeError:
                    continue
            else:
                return None
            return round(xs[int((len(xs) - 1) * frac)] * 1e3, 2) \
                if xs else None

        pc = self.prefix_cache
        return {**self._stats, "active_slots": active,
                "free_pages": self.allocator.num_free(),
                "waiting": self._waiting.qsize(),
                "prefix_cache": pc.stats() if pc is not None else None,
                "resident_pages": self.allocator.num_resident(),
                "p50_queue_wait_ms": _pctile(self._queue_waits, 0.5),
                "p90_queue_wait_ms": _pctile(self._queue_waits, 0.9),
                "p50_prefill_ms": _pctile(self._prefill_times, 0.5),
                "p90_prefill_ms": _pctile(self._prefill_times, 0.9)}

    # ------------------------- scheduler loop ------------------------------

    def _loop(self):
        # inference mode is thread-local: it must be entered on this thread
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    admitted = self._admit()
                    stepped = self._decode_all()
                except Exception as e:  # noqa: BLE001 — a dead scheduler
                    # thread would hang every generate() forever; fail the
                    # in-flight requests loudly instead and keep serving.
                    traceback.print_exc()
                    self._fail_all(e)
                    continue
                if not admitted and not stepped:
                    time.sleep(0.002)

    def _fail_all(self, e: Exception) -> None:
        for i, s in enumerate(self._slots):
            if s is not None:
                s.request.out_queue.put(e)
                s.request.out_queue.put(None)
                self.allocator.free(s.pages)
                self._slots[i] = None
        while True:
            try:
                req = self._waiting.get_nowait()
            except queue_mod.Empty:
                break
            req.out_queue.put(e)
            req.out_queue.put(None)

    def _pick_waiting(self) -> Optional[_Request]:
        """Next request to admit: FIFO normally; under pool pressure (the
        head's pages aren't free) prefer the waiting request with the most
        prefix tokens resident — admitting a hit costs fewer fresh pages
        and zero evictions.  Bounded: once the head has waited
        RTPU_ADMIT_AGE_CAP_S it goes next regardless, so misses can't
        starve.  Scans only the first 8 waiters via peek (no LRU refresh —
        ranking must not reorder eviction)."""
        q = self._waiting.queue  # type: ignore[attr-defined]
        if not q:
            return None
        head = q[0]
        pc = self.prefix_cache
        pressure = False
        if pc is not None:
            need = len(head.prompt_tokens) // self.cfg.page_size + 1
            pressure = self.allocator.num_free() < need
        if (not pressure or time.monotonic() - head.submitted_at
                >= self._admit_age_cap_s):
            try:
                return self._waiting.get_nowait()
            except queue_mod.Empty:
                return None
        best_i, best_m = 0, -1
        for i in range(min(8, len(q))):
            m = pc.peek_match_tokens(q[i].prompt_tokens)
            if m > best_m:
                best_i, best_m = i, m
        try:
            req = q[best_i]
            del q[best_i]
        except IndexError:  # drained between len() and del (benign)
            return None
        return req

    def _admit(self) -> bool:
        """Move waiting requests into free slots while pages last."""
        admitted = False
        while True:
            req = self._pick_waiting()
            if req is None:
                return admitted
            free_slot = next((i for i, s in enumerate(self._slots)
                              if s is None), None)
            if free_slot is None:
                self._waiting.queue.appendleft(req)  # type: ignore[attr-defined]
                return admitted
            # Lazy allocation: admit with just the pages the prompt + the
            # first decode write need; _ensure_capacity grows the slot as
            # decode advances, evicting cache LRU or preempting when the
            # pool runs dry.
            n = len(req.prompt_tokens)
            matched: List[int] = []
            cow_src: Optional[int] = None
            cow_len = 0
            if self.prefix_cache is not None:
                matched, cow_src, cow_len = \
                    self.prefix_cache.match_cow(req.prompt_tokens)
            need_total = n // self.cfg.page_size + 1
            # pin matched pages — and the COW source, which eviction in
            # _reserve would otherwise reclaim before the copy — BEFORE
            # eviction can consider them
            pin = matched + ([cow_src] if cow_src is not None else [])
            self.allocator.retain(pin)
            if not self._reserve(need_total - len(matched)):
                self.allocator.free(pin)  # unpin; stays resident
                self._waiting.queue.appendleft(req)  # type: ignore[attr-defined]
                return admitted
            pages = matched + self.allocator.allocate(
                need_total - len(matched))
            prefix_len = len(matched) * self.cfg.page_size
            rng = (np.random.default_rng(req.params.seed)
                   if req.params.temperature > 0 else None)
            try:
                if cow_src is not None:
                    # COW boundary page: duplicate the diverging block's
                    # page into this sequence's first fresh page, then
                    # prefill only past the shared slots.  Slots >= cow_len
                    # hold the OTHER sequence's KV, but the suffix prefill
                    # overwrites every one of them before attention reads
                    # it (null-page invariant).
                    dst = pages[len(matched)]
                    lm.copy_page(self.cache_k, self.cache_v, cow_src, dst)
                    prefix_len += cow_len
                    self._stats["cow_copies"] += 1
                last = self._prefill(req, pages, rng, prefix_len)
            except Exception as e:  # noqa: BLE001 — surface to caller
                self.allocator.free(pages)
                req.out_queue.put(e)
                req.out_queue.put(None)
                continue
            finally:
                if cow_src is not None:
                    self.allocator.free([cow_src])  # drop the copy pin
            if self.prefix_cache is not None:
                # commit hit/lookup accounting only on successful admission
                self.prefix_cache.note_lookup(n, prefix_len)
                self._stats["prefill_tokens_saved"] += prefix_len
            # every full prompt page is now index-able for later prompts
            # sharing the prefix
            self._register_blocks(req.prompt_tokens, pages)
            slot = _Slot(request=req, pages=pages,
                         num_tokens=len(req.prompt_tokens),
                         last_token=last, rng=rng)
            if last in req.params.stop_token_ids:
                req.out_queue.put(None)
                self.allocator.free(pages)
            else:
                slot.generated.append(last)
                self._emit(slot, last)
                if req.produced >= req.params.max_tokens:
                    req.out_queue.put(None)
                    self.allocator.free(pages)
                else:
                    self._slots[free_slot] = slot
            admitted = True

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill(self, req: _Request, pages: List[int],
                 rng: Optional[np.random.Generator],
                 prefix_len: int = 0) -> int:
        n = len(req.prompt_tokens)
        ps = self.cfg.page_size
        t0 = time.monotonic()
        if prefix_len > 0:
            # prefix-cache hit: pages[:prefix_len//ps] already hold the
            # prefix KV; compute only the suffix, attending through the
            # full page table (every write position is >= prefix_len)
            suffix = req.prompt_tokens[prefix_len:]
            ls = len(suffix)
            bucket = self.cfg.bucket_for(ls)
            tokens = np.zeros(bucket, np.int64)
            tokens[:ls] = suffix
            positions = prefix_len + np.arange(bucket, dtype=np.int64)
            pi = positions // ps
            page_rows = np.where(pi < len(pages),
                                 np.asarray(pages)[np.minimum(
                                     pi, len(pages) - 1)], 0)
            slot_positions = positions % ps
            table = np.zeros(self.max_pages_per_seq, np.int64)
            table[:len(pages)] = pages
            logits = lm.prefill_with_prefix(
                self.state, self._tensor(tokens), self.cache_k,
                self.cache_v, self._tensor(page_rows), ls,
                self._tensor(slot_positions), self._tensor(table),
                self._tensor(positions), self.model_cfg)
        else:
            bucket = self.cfg.bucket_for(n)
            tokens = np.zeros(bucket, np.int64)
            tokens[:n] = req.prompt_tokens
            # map each padded position to (page, slot); positions beyond
            # the allocated pages land in the null page
            pi = np.arange(bucket) // ps
            page_rows = np.where(pi < len(pages),
                                 np.asarray(pages)[np.minimum(
                                     pi, len(pages) - 1)], 0)
            slot_positions = np.arange(bucket, dtype=np.int64) % ps
            logits = lm.prefill(
                self.state, self._tensor(tokens), self.cache_k,
                self.cache_v, self._tensor(page_rows), n,
                self._tensor(slot_positions), self.model_cfg)
        out = self._sample_one(logits.cpu().numpy(), req.params, rng)
        self._stats["prefills"] += 1
        self._stats["admitted"] += 1
        self._prefill_times.append(time.monotonic() - t0)
        self._queue_waits.append(t0 - req.submitted_at)
        return out

    def _reserve(self, n: int) -> bool:
        """Make n pages allocatable, reclaiming prefix-cache pages as
        needed.  Returns False (leaving partial reclaims in place — they
        were the coldest blocks anyway) if the pool can't cover it."""
        if n <= 0:
            return True
        pc = self.prefix_cache
        while self.allocator.num_free() < n:
            hit = pc.evict_one(self.allocator.refcount) \
                if pc is not None else None
            if hit is None:
                return False
            self.allocator.reclaim(hit[0])
            self._stats["page_evictions"] += 1
        return True

    def _register_blocks(self, tokens: List[int], pages: List[int]) -> None:
        if self.prefix_cache is None:
            return
        cached = self.prefix_cache.insert(tokens, pages)
        self.allocator.mark_cached(cached)

    def _preempt(self, i: int, s: _Slot) -> None:
        """Evict a running sequence (recompute preemption): accepted tokens
        fold into the prompt and the request requeues at the FRONT.  Its
        full pages are registered in the prefix cache first, so the resume
        prefill usually restarts from a long prefix hit."""
        req = s.request
        seq = req.prompt_tokens + s.generated
        # KV is resident exactly for positions < num_tokens
        self._register_blocks(seq[:s.num_tokens], s.pages)
        req.prompt_tokens = seq
        self.allocator.free(s.pages)
        self._slots[i] = None
        self._stats["preempted"] += 1
        req.preempts += 1
        self._waiting.queue.appendleft(req)  # type: ignore[attr-defined]

    def _shared_pages(self, s: _Slot) -> int:
        """Pages of slot `s` also held by another sequence or by the
        prefix cache — KV that survives this slot's preemption for free."""
        alloc = self.allocator
        return sum(1 for p in s.pages
                   if alloc.refcount(p) > 1 or alloc.is_cached(p))

    def _ensure_capacity(self, steps: int) -> None:
        """Grow each slot's page list to cover the next `steps` decode
        writes.  Earliest-submitted slots grow first; when the pool is dry
        even after cache eviction, the victim is the slot holding the
        FEWEST shared pages; ties fall to the latest-submitted slot."""
        ps = self.cfg.page_size
        order = sorted(
            ((i, s) for i, s in enumerate(self._slots) if s is not None),
            key=lambda t: t[1].request.submitted_at)
        for i, s in order:
            while self._slots[i] is s:
                sp = s.request.params
                remaining = max(1, sp.max_tokens - s.request.produced)
                k = min(steps, remaining)
                need = min((s.num_tokens + k - 1) // ps + 1,
                           self.max_pages_per_seq)
                delta = need - len(s.pages)
                if delta <= 0:
                    break
                if self._reserve(delta):
                    s.pages.extend(self.allocator.allocate(delta))
                    break
                victim = min(
                    ((j, t) for j, t in enumerate(self._slots)
                     if t is not None),
                    key=lambda t: (self._shared_pages(t[1]),
                                   -t[1].request.submitted_at))
                self._preempt(*victim)
                # if we preempted ourselves the while condition exits

    def _decode_all(self) -> bool:
        active_slots = [(i, s) for i, s in enumerate(self._slots)
                        if s is not None]
        if not active_slots:
            return False
        all_greedy = all(s.request.params.temperature <= 0
                         for _, s in active_slots)
        # Burst decode: chain several greedy steps on the device and fetch
        # once.  Overshoot is safe: a slot that finishes mid-burst keeps
        # writing into its own (or the null) pages and the extra tokens are
        # not emitted.  Stay responsive to admissions only when one could
        # actually happen: work waiting, a free slot, and enough pool
        # headroom (free + reclaimable cache pages) for the head request.
        can_admit = False
        if any(s is None for s in self._slots):
            try:
                head = self._waiting.queue[0]  # type: ignore[attr-defined]
                n_pages = len(head.prompt_tokens) // self.cfg.page_size + 1
                can_admit = (self.allocator.num_free()
                             + self.allocator.num_resident()) >= n_pages
            except IndexError:
                pass
        burst = 8 if (all_greedy and not can_admit) else 1
        # lazy allocation's second half: cover the burst's decode writes,
        # preempting under pool pressure — slots may vanish here
        self._ensure_capacity(burst)
        active_slots = [(i, s) for i, s in enumerate(self._slots)
                        if s is not None]
        if not active_slots:
            return True  # everything preempted; _admit resumes them
        B = self.cfg.max_slots
        P = self.max_pages_per_seq
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        tables = np.zeros((B, P), np.int64)
        active = np.zeros(B, bool)
        for i, s in active_slots:
            tokens[i] = s.last_token
            positions[i] = s.num_tokens  # position of the new token
            tables[i, :len(s.pages)] = s.pages
            active[i] = True
        toks_dev = self._tensor(tokens)
        pos_dev = self._tensor(positions)
        tables_dev = self._tensor(tables)
        active_dev = self._tensor(active)
        if all_greedy:
            steps = []
            for j in range(burst):
                toks_dev = lm.decode_step_greedy(
                    self.state, toks_dev, self.cache_k, self.cache_v,
                    tables_dev, pos_dev + j, active_dev,
                    self.model_cfg).long()
                steps.append(toks_dev)
            # ONE host round trip for the whole burst
            rows = torch.stack(steps).cpu().numpy()
            self._stats["decode_steps"] += burst
            for row in rows:
                for i, s in active_slots:
                    if self._slots[i] is not s:
                        continue  # finished earlier in this burst
                    self._accept_token(i, s, int(row[i]))
            return True
        logits = lm.decode_step(
            self.state, toks_dev, self.cache_k, self.cache_v, tables_dev,
            pos_dev, active_dev, self.model_cfg)
        logits_np = logits.cpu().numpy()
        self._stats["decode_steps"] += 1
        for i, s in active_slots:
            tok = self._sample_one(logits_np[i], s.request.params, s.rng)
            self._accept_token(i, s, tok)
        return True

    def _accept_token(self, i: int, s: _Slot, tok: int):
        """Record one sampled token for slot i: emit, finish, or continue."""
        s.num_tokens += 1  # last_token's KV is now in the cache
        sp = s.request.params
        if tok in sp.stop_token_ids:
            self._release_slot(i, s)
            return
        s.generated.append(tok)
        self._emit(s, tok)
        if s.request.produced >= sp.max_tokens:
            self._release_slot(i, s)
        else:
            s.last_token = tok

    def _release_slot(self, i: int, s: _Slot) -> None:
        """Finish a sequence: register its full pages (prompt AND generated
        KV) and release; cached pages stay resident until the pool
        reclaims them."""
        s.request.out_queue.put(None)
        seq = s.request.prompt_tokens + s.generated
        self._register_blocks(seq[:s.num_tokens], s.pages)
        self.allocator.free(s.pages)
        self._slots[i] = None

    def _emit(self, slot: _Slot, token: int):
        self._stats["tokens_generated"] += 1
        req = slot.request
        req.emitted += 1
        req.produced += 1  # survives preemption (len(generated) does not)
        if req.first_token_at is None:
            req.first_token_at = time.monotonic()
        req.out_queue.put(int(token))

    def _sample_one(self, logits: np.ndarray, params: SamplingParams,
                    rng: Optional[np.random.Generator]) -> int:
        if params.temperature <= 0 or rng is None:
            return int(np.argmax(logits))
        probs = logits / params.temperature
        probs = np.exp(probs - probs.max())
        probs /= probs.sum()
        if params.top_p < 1.0:
            order = np.argsort(-probs)
            csum = np.cumsum(probs[order])
            cut = np.searchsorted(csum, params.top_p) + 1
            keep = order[:cut]
            mask = np.zeros_like(probs)
            mask[keep] = probs[keep]
            probs = mask / mask.sum()
        return int(rng.choice(len(probs), p=probs))
