"""In-memory ring-buffer TSDB: the head's retained-signal plane.

Counterpart of the reference's metrics-history layer (the dashboard's
Prometheus+Grafana stack, dashboard/modules/metrics/): every observability
surface so far is a point-in-time scrape, so nothing in the cluster can
answer "what was the p90 TTFT over the last 5 minutes" — the signal the
SLO engine (_private/slo.py) and ROADMAP item 3's autoscaler judge against.

The head's dashboard samples every node's ``metrics_snapshot`` on a cadence
(``RTPU_TSDB_SAMPLE_S``) and feeds the documents to :meth:`TSDB.ingest`.
Storage is fixed-cap per-series deques keyed by (family, tags, source);
stale series are evicted least-recently-updated past ``max_series``, so
head memory is bounded by ``points_per_series * max_series`` regardless of
cluster size or uptime (BASELINE.md documents the cap).

Counter-reset handling: cumulative counters are normalized at ingest into
a monotone "adjusted" value.  Each sample carries an optional *generation*
(the store daemon's restart incarnation, a worker's source id) — when the
generation changes the new raw value counts from zero on top of the old
total (a restart, not a decrease); a raw decrease *within* one generation
is clamped to zero delta (a decrease, not a restart).  Windowed ``rate()``
can therefore never go negative, SIGKILL mid-sample included.

All stdlib, no new deps.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

# Runtime families synthesized from metrics_snapshot's "runtime" dict are
# prefixed "node_"; entries ending in _total are cumulative counters whose
# generation is the store daemon incarnation (see scheduler.py
# metrics_snapshot / node.py _supervise_store).
_SKIP_RUNTIME = ("node_id", "available", "resources", "store_incarnation")


def _tags_key(tags) -> tuple:
    """Canonical tags: sorted (key, value) string pairs."""
    if not tags:
        return ()
    if isinstance(tags, dict):
        tags = tags.items()
    return tuple(sorted((str(k), str(v)) for k, v in tags))


class _Series:
    __slots__ = ("family", "kind", "tags", "source", "points", "gen",
                 "last_raw", "offset", "boundaries", "cap", "exemplars")

    def __init__(self, family: str, kind: str, tags: tuple, source: str,
                 cap: int, boundaries=None):
        self.family = family
        self.kind = kind
        self.tags = tags
        self.source = source
        self.cap = cap
        self.points: list = []  # [(ts, value-or-vector)], ring via del[0]
        self.gen = None
        self.last_raw = None    # float (counter) or list (histogram)
        self.offset = None      # float or list, added to raw -> monotone
        self.boundaries = tuple(boundaries or ())
        # histogram only: bucket index -> trace id of the LAST observation
        # that landed there (exemplar linkage; bounded by bucket count)
        self.exemplars: dict = {}

    def _append(self, ts: float, value) -> None:
        self.points.append((ts, value))
        if len(self.points) > self.cap:
            del self.points[:len(self.points) - self.cap]

    def add_gauge(self, ts: float, value: float) -> None:
        self._append(ts, float(value))

    def add_counter(self, ts: float, raw: float, gen=None) -> None:
        raw = float(raw)
        if self.last_raw is None:
            self.offset = 0.0
            self.gen = gen
        elif gen is not None and gen != self.gen:
            # new generation: a restart — the counter restarts from zero,
            # so everything it now reports is NEW increments on top of the
            # previous adjusted total
            self.offset = self.offset + self.last_raw
            self.gen = gen
        elif raw < self.last_raw:
            if gen is None:
                # no generation info: a drop on a counter can only be a
                # reset, count the new value as fresh increments
                self.offset = self.offset + self.last_raw
            else:
                # same generation but decreased: a genuine (buggy)
                # decrease, not a reset — clamp the delta to zero
                self.offset = self.offset + (self.last_raw - raw)
        self.last_raw = raw
        self._append(ts, self.offset + raw)

    def add_hist(self, ts: float, raw, gen=None, exemplars=None) -> None:
        if exemplars:
            for bucket, tid in exemplars.items():
                try:
                    self.exemplars[int(bucket)] = str(tid)
                except (TypeError, ValueError):
                    continue
        # raw: [bucket counts..., +inf count, sum] — every component is a
        # cumulative counter; normalize the vector with the same
        # reset-vs-decrease rule as add_counter
        raw = [float(v) for v in raw]
        if self.last_raw is None or len(raw) != len(self.last_raw):
            self.offset = [0.0] * len(raw)
            self.gen = gen
        elif gen is not None and gen != self.gen:
            self.offset = [o + r for o, r in zip(self.offset, self.last_raw)]
            self.gen = gen
        elif any(r < lr for r, lr in zip(raw, self.last_raw)):
            if gen is None:
                self.offset = [o + r
                               for o, r in zip(self.offset, self.last_raw)]
            else:
                self.offset = [o + max(0.0, lr - r) for o, lr, r
                               in zip(self.offset, self.last_raw, raw)]
        self.last_raw = raw
        self._append(ts, tuple(o + r for o, r in zip(self.offset, raw)))

    def window_delta(self, start_ts: float, now: float):
        """Increase of the adjusted cumulative value over [start_ts, now]:
        latest point minus the baseline (last point at/before start_ts,
        else the earliest retained point).  None when the series has no
        point inside the window (stale: it contributes nothing)."""
        pts = self.points
        if not pts:
            return None
        last_ts, last_v = pts[-1]
        if last_ts < start_ts:
            return None
        base = None
        for ts, v in reversed(pts):
            if ts <= start_ts:
                base = v
                break
        if base is None:
            base = pts[0][1]
        if isinstance(last_v, tuple):
            return tuple(lv - bv for lv, bv in zip(last_v, base))
        return last_v - base

    def window_points(self, start_ts: float) -> list:
        return [(ts, v) for ts, v in self.points if ts >= start_ts]


class TSDB:
    """Fixed-cap ring-buffer time-series store with windowed aggregation."""

    def __init__(self, points_per_series: int = 512, max_series: int = 2048):
        self.points_per_series = max(2, int(points_per_series))
        self.max_series = max(1, int(max_series))
        self._lock = threading.Lock()
        # (family, tags, source) -> _Series, LRU-ordered by last update
        self._series: "OrderedDict[tuple, _Series]" = OrderedDict()
        self._by_family: dict[str, set] = {}
        self._kinds: dict[str, str] = {}
        self.ingested = 0

    # -- ingest ----------------------------------------------------------
    def _get_series(self, family: str, kind: str, tags: tuple, source: str,
                    boundaries=None) -> _Series:
        key = (family, tags, source)
        s = self._series.get(key)
        if s is None:
            while len(self._series) >= self.max_series:
                old_key, _ = self._series.popitem(last=False)
                fam_keys = self._by_family.get(old_key[0])
                if fam_keys is not None:
                    fam_keys.discard(old_key)
                    if not fam_keys:
                        self._by_family.pop(old_key[0], None)
                        self._kinds.pop(old_key[0], None)
            s = _Series(family, kind, tags, source, self.points_per_series,
                        boundaries)
            self._series[key] = s
            self._by_family.setdefault(family, set()).add(key)
            self._kinds[family] = kind
        else:
            self._series.move_to_end(key)
        return s

    def ingest(self, snap: dict, ts: float) -> None:
        """Ingest one node's ``metrics_snapshot`` document at time ts."""
        with self._lock:
            self._ingest_locked(snap, float(ts))
            self.ingested += 1

    def _ingest_locked(self, snap: dict, ts: float) -> None:
        rt = snap.get("runtime") or {}
        nid = rt.get("node_id")
        node = (bytes(nid).hex()[:12]
                if isinstance(nid, (bytes, bytearray)) else str(nid or ""))
        node_tags = _tags_key({"node": node})
        store_gen = rt.get("store_incarnation")
        for key, val in rt.items():
            if key in _SKIP_RUNTIME or not isinstance(val, (int, float)):
                continue
            family = "node_" + key
            if key.endswith("_total"):
                gen = store_gen if key.startswith("store_") else None
                self._get_series(family, "counter", node_tags,
                                 node).add_counter(ts, val, gen)
            else:
                self._get_series(family, "gauge", node_tags,
                                 node).add_gauge(ts, val)
        res_total = rt.get("resources") or {}
        res_avail = rt.get("available") or {}
        for res, total in res_total.items():
            tags = _tags_key({"node": node, "resource": str(res)})
            self._get_series("node_resource_capacity", "gauge", tags,
                             node).add_gauge(ts, total)
            self._get_series("node_resource_available", "gauge", tags,
                             node).add_gauge(ts, res_avail.get(res, 0))
        sources = snap.get("app_sources") or ()
        for i, ms in enumerate(snap.get("app") or ()):
            src = node + "/" + (str(sources[i]) if i < len(sources)
                                else str(i))
            for m in ms:
                self._ingest_metric(m, src, ts)

    def _ingest_metric(self, m: dict, source: str, ts: float) -> None:
        family = m.get("name")
        kind = m.get("kind")
        if not family or kind not in ("counter", "gauge", "histogram"):
            return
        keys = tuple(m.get("tag_keys") or ())
        if kind == "histogram":
            bounds = tuple(m.get("boundaries") or ())
            ex_by_tags = m.get("exemplars") or {}
            for tagvals, h in (m.get("hist") or {}).items():
                tags = _tags_key(zip(keys, tuple(tagvals)))
                s = self._get_series(family, kind, tags, source, bounds)
                s.add_hist(ts, h, exemplars=ex_by_tags.get(tagvals))
            return
        for tagvals, v in (m.get("values") or {}).items():
            tags = _tags_key(zip(keys, tuple(tagvals)))
            s = self._get_series(family, kind, tags, source)
            if kind == "counter":
                # a worker restart is a NEW source (worker ids are fresh),
                # so per-series raw drops can only be true resets
                s.add_counter(ts, v)
            else:
                s.add_gauge(ts, v)

    # -- windowed aggregation -------------------------------------------
    def _family_series(self, family: str) -> list:
        return [self._series[k] for k in self._by_family.get(family, ())
                if k in self._series]

    def _now(self, now: Optional[float]) -> float:
        if now is not None:
            return float(now)
        latest = 0.0
        for s in self._series.values():
            if s.points:
                latest = max(latest, s.points[-1][0])
        return latest

    def rate(self, family: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Summed per-second increase of a counter family over the window
        (non-negative by construction).  None when the family is unknown;
        0.0 when it exists but nothing moved."""
        with self._lock:
            series = self._family_series(family)
            if not series:
                return None
            now = self._now(now)
            start = now - float(window_s)
            total = 0.0
            for s in series:
                d = s.window_delta(start, now)
                if d is None:
                    continue
                if isinstance(d, tuple):
                    # histogram: rate of observations = count delta
                    # (sum of buckets incl. +inf; d[-1] is the value sum)
                    total += sum(d[:-1])
                else:
                    total += d
            return max(0.0, total) / max(1e-9, float(window_s))

    def rate_by(self, family: str, window_s: float,
                now: Optional[float] = None) -> dict:
        """Per-tags rates (sources with identical tags summed)."""
        out: dict[tuple, float] = {}
        with self._lock:
            series = self._family_series(family)
            now = self._now(now)
            start = now - float(window_s)
            for s in series:
                d = s.window_delta(start, now)
                if d is None:
                    continue
                if isinstance(d, tuple):
                    d = sum(d[:-1])
                out[s.tags] = out.get(s.tags, 0.0) + max(0.0, d)
        w = max(1e-9, float(window_s))
        return {t: v / w for t, v in out.items()}

    def quantile(self, family: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """Histogram quantile over the window, from merged bucket deltas
        across every series of the family (linear interpolation inside
        the winning bucket; the +inf bucket reports the top boundary).
        None when no observation landed in the window."""
        with self._lock:
            series = [s for s in self._family_series(family)
                      if s.kind == "histogram"]
            if not series:
                return None
            now = self._now(now)
            start = now - float(window_s)
            bounds = None
            merged = None
            for s in series:
                d = s.window_delta(start, now)
                if d is None:
                    continue
                counts = [max(0.0, c) for c in d[:-1]]
                if merged is None:
                    bounds = s.boundaries
                    merged = counts
                elif s.boundaries == bounds and len(counts) == len(merged):
                    merged = [a + b for a, b in zip(merged, counts)]
            if not merged:
                return None
            total = sum(merged)
            if total <= 0:
                return None
            target = max(0.0, min(1.0, float(q))) * total
            cum = 0.0
            for i, c in enumerate(merged):
                prev_cum = cum
                cum += c
                if cum >= target and c > 0:
                    if i >= len(bounds):
                        return float(bounds[-1]) if bounds else 0.0
                    lo = float(bounds[i - 1]) if i > 0 else 0.0
                    hi = float(bounds[i])
                    return lo + (hi - lo) * ((target - prev_cum) / c)
            return float(bounds[-1]) if bounds else 0.0

    def exemplar(self, family: str, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[str]:
        """Trace id of an observation representative of the family's
        q-quantile over the window: walk the merged bucket deltas to the
        quantile's bucket (same walk as :meth:`quantile`), then return the
        banked exemplar at that bucket — or the nearest populated bucket at
        or above it, so "which request was the p99" answers with the worst
        traced request even when the exact bucket carried no exemplar."""
        with self._lock:
            series = [s for s in self._family_series(family)
                      if s.kind == "histogram"]
            if not series:
                return None
            now = self._now(now)
            start = now - float(window_s)
            bounds = None
            merged = None
            ex: dict[int, str] = {}
            for s in series:
                d = s.window_delta(start, now)
                if d is None:
                    continue
                counts = [max(0.0, c) for c in d[:-1]]
                if merged is None:
                    bounds = s.boundaries
                    merged = counts
                elif s.boundaries == bounds and len(counts) == len(merged):
                    merged = [a + b for a, b in zip(merged, counts)]
                else:
                    continue
                for b, t in s.exemplars.items():
                    if 0 <= int(b) < len(counts):
                        ex[int(b)] = t
            if not merged or not ex:
                return None
            total = sum(merged)
            if total <= 0:
                return None
            target = max(0.0, min(1.0, float(q))) * total
            cum = 0.0
            hit = len(merged) - 1
            for i, c in enumerate(merged):
                cum += c
                if cum >= target and c > 0:
                    hit = i
                    break
            for i in range(hit, len(merged)):
                if i in ex:
                    return ex[i]
            for i in range(hit - 1, -1, -1):
                if i in ex:
                    return ex[i]
            return None

    def gauge_agg(self, family: str, window_s: float, fn: str = "mean",
                  now: Optional[float] = None) -> Optional[float]:
        """mean/max/min over every in-window point of a gauge family, or
        'latest' (the most recent point).  None when nothing is in
        the window."""
        with self._lock:
            series = self._family_series(family)
            if not series:
                return None
            now = self._now(now)
            start = now - float(window_s)
            vals: list[float] = []
            latest: Optional[tuple] = None
            for s in series:
                for ts, v in s.window_points(start):
                    if isinstance(v, tuple):
                        continue
                    vals.append(v)
                    if latest is None or ts > latest[0]:
                        latest = (ts, v)
            if not vals:
                return None
            if fn == "latest":
                return latest[1]
            if fn == "max":
                return max(vals)
            if fn == "min":
                return min(vals)
            return sum(vals) / len(vals)

    # -- introspection ---------------------------------------------------
    def families(self) -> list[dict]:
        with self._lock:
            return sorted(
                ({"family": f, "kind": self._kinds.get(f, ""),
                  "series": len(keys)}
                 for f, keys in self._by_family.items()),
                key=lambda r: r["family"])

    def query(self, family: str, window_s: float,
              now: Optional[float] = None) -> list[dict]:
        """Raw in-window points per series (the /api/timeseries payload)."""
        with self._lock:
            series = self._family_series(family)
            now = self._now(now)
            start = now - float(window_s)
            out = []
            for s in series:
                pts = s.window_points(start)
                if not pts:
                    continue
                row = {
                    "family": s.family, "kind": s.kind,
                    "tags": dict(s.tags), "source": s.source,
                    "boundaries": list(s.boundaries),
                    "points": [[ts, list(v) if isinstance(v, tuple) else v]
                               for ts, v in pts],
                }
                if s.exemplars:
                    row["exemplars"] = {int(b): t
                                        for b, t in s.exemplars.items()}
                out.append(row)
            return out

    def overview(self, window_s: float,
                 now: Optional[float] = None) -> list[dict]:
        """One judged row per family for ``rtpu top``: counters report the
        windowed rate, gauges the latest value, histograms windowed
        p50/p90 + observation rate; per-tags detail rides along."""
        fams = self.families()
        rows = []
        for f in fams:
            family, kind = f["family"], f["kind"]
            row = {"family": family, "kind": kind, "series": f["series"]}
            if kind == "counter":
                row["rate"] = self.rate(family, window_s, now)
                row["by"] = {
                    ",".join(f"{k}={v}" for k, v in tags) or "-": round(r, 4)
                    for tags, r in sorted(
                        self.rate_by(family, window_s, now).items(),
                        key=lambda kv: -kv[1])[:8]}
            elif kind == "histogram":
                row["rate"] = self.rate(family, window_s, now)
                row["p50"] = self.quantile(family, 0.5, window_s, now)
                row["p90"] = self.quantile(family, 0.9, window_s, now)
            else:
                row["value"] = self.gauge_agg(family, window_s, "latest",
                                              now)
                row["mean"] = self.gauge_agg(family, window_s, "mean", now)
            rows.append(row)
        return rows

    def stats(self) -> dict:
        """Bounded-memory accounting (the BASELINE.md row): series/point
        counts plus a pessimistic bytes estimate (tuples of floats; hist
        points cost one slot per bucket)."""
        with self._lock:
            n_points = 0
            n_slots = 0
            for s in self._series.values():
                n_points += len(s.points)
                width = (len(s.boundaries) + 2
                         if s.kind == "histogram" else 1)
                n_slots += len(s.points) * (1 + width)
            return {
                "series": len(self._series),
                "families": len(self._by_family),
                "points": n_points,
                "ingested": self.ingested,
                "approx_bytes": n_slots * 32 + len(self._series) * 512,
                "cap_points": self.points_per_series * self.max_series,
            }


# -- plane registry ------------------------------------------------------
# The head's MetricsSampler (dashboard/head.py) registers itself here so
# the scheduler's control socket can serve query_timeseries/slo_status/
# tsdb_overview to the CLI and state API without an HTTP dependency.
_plane = None
_plane_lock = threading.Lock()


def set_global_plane(plane) -> None:
    global _plane
    with _plane_lock:
        _plane = plane


def global_plane():
    return _plane
