"""Declarative SLO rules + fast/slow multi-window burn-rate alerting.

The judgment layer over the ring TSDB (_private/tsdb.py): rules are one
line each, evaluated on every sample tick by the head's MetricsSampler
(dashboard/head.py).  Grammar::

    name: agg(family, window) [/ agg(family, window)] < threshold
    name: family > threshold                  (bare = latest(family, 1m))

with ``agg`` one of ``rate`` (counters/histograms), ``mean``/``max``/
``min``/``latest`` (gauges) or ``pNN`` (histogram quantile over the
window), windows like ``30s``/``5m``/``1h``, and one optional ratio
(error-rate style).  Extra rules come from ``RTPU_SLO_RULES``
(semicolon-separated; a rule named like a default replaces it).

Burn rate is "how hard is the objective being violated": measured/threshold
for ``<`` objectives, threshold/measured for ``>``.  An alert FIRES when
both the fast window (window/5, floored at 2 samples) and the slow window
(the rule's stated window) burn above 1.0 — the fast window makes the
alert land within about one sample period of the breach, the slow window
keeps blips from paging.  It CLEARS with hysteresis: the fast burn must
sit below ``clear_ratio`` for ``clear_ticks`` consecutive ticks.  A window
with no data burns 0 (no traffic is not an outage), which is also how a
fired alert drains once breach samples age out of the window.

Alert transitions are events on the cluster event plane ("slo.fire" /
"slo.clear"); current burn state is exported as the ``slo_burn_rate`` and
``slo_healthy`` gauge families so ROADMAP item 3's autoscaler can consume
cluster health as one number.
"""

from __future__ import annotations

import re
import time
from typing import Optional

# Validated by staticcheck/metrics_lint.py: every family referenced here
# must be a registered metric family (metrics/slo-unknown-family).
DEFAULT_RULES = (
    "serve_error_rate: rate(serve_errors_total, 1m)"
    " / rate(serve_requests_total, 1m) < 0.01",
    "llm_ttft_p90: p90(llm_ttft_s, 5m) < 1.5",
    "train_goodput: mean(train_goodput_fraction, 5m) > 0.9",
)

_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "": 1.0}
_TERM_RE = re.compile(
    r"^\s*(?:(rate|mean|max|min|latest|p\d{1,2}(?:\.\d+)?)\s*\(\s*"
    r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:,\s*([0-9.]+)\s*([smh]?)\s*)?\)"
    r"|([A-Za-z_][A-Za-z0-9_]*))\s*$")
_RULE_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z0-9_.-]*)\s*:\s*(.+?)\s*(<=|>=|<|>)\s*"
    r"([0-9.eE+-]+)\s*$")

DEFAULT_WINDOW_S = 60.0


class RuleError(ValueError):
    pass


class _Term:
    __slots__ = ("func", "family", "window_s")

    def __init__(self, text: str):
        m = _TERM_RE.match(text)
        if not m:
            raise RuleError(f"unparseable SLO term {text!r}")
        if m.group(5):
            self.func, self.family = "latest", m.group(5)
            self.window_s = DEFAULT_WINDOW_S
        else:
            self.func, self.family = m.group(1), m.group(2)
            self.window_s = (float(m.group(3)) * _UNITS[m.group(4) or ""]
                             if m.group(3) else DEFAULT_WINDOW_S)

    def eval(self, tsdb, window_s: float,
             now: Optional[float]) -> Optional[float]:
        if self.func == "rate":
            return tsdb.rate(self.family, window_s, now)
        if self.func.startswith("p"):
            return tsdb.quantile(self.family, float(self.func[1:]) / 100.0,
                                 window_s, now)
        return tsdb.gauge_agg(self.family, window_s, self.func, now)


class Rule:
    """One parsed SLO rule; evaluation is side-effect free."""

    def __init__(self, text: str):
        m = _RULE_RE.match(text)
        if not m:
            raise RuleError(f"unparseable SLO rule {text!r}")
        self.text = text.strip()
        self.name = m.group(1)
        self.op = m.group(3)
        self.threshold = float(m.group(4))
        expr = m.group(2)
        # one optional ratio; '/' never appears inside a term
        if "/" in expr:
            num_s, _, den_s = expr.partition("/")
            self.num, self.den = _Term(num_s), _Term(den_s)
        else:
            self.num, self.den = _Term(expr), None
        self.window_s = max(self.num.window_s,
                            self.den.window_s if self.den else 0.0)

    def families(self) -> list[str]:
        fams = [self.num.family]
        if self.den is not None:
            fams.append(self.den.family)
        return fams

    def value(self, tsdb, window_s: Optional[float] = None,
              now: Optional[float] = None) -> Optional[float]:
        """Evaluate at an overridden window (the burn engine scales the
        rule's terms together so a ratio stays apples-to-apples)."""
        w = float(window_s or self.window_s)
        num = self.num.eval(tsdb, w, now)
        if self.den is None:
            return num
        den = self.den.eval(tsdb, w, now)
        if den is None or den <= 0:
            return None  # no traffic -> no verdict
        # denominator has data: an absent/quiet numerator family means
        # zero bad events, not "unknown"
        return (num or 0.0) / den

    def burn(self, value: Optional[float]) -> Optional[float]:
        if value is None:
            return None
        if self.op in ("<", "<="):
            if self.threshold <= 0:
                return 0.0 if value <= 0 else float("inf")
            return max(0.0, value / self.threshold)
        if value <= 0:
            return float("inf")
        return max(0.0, self.threshold / value)


def parse_rules(text: str) -> list[Rule]:
    rules = []
    for part in re.split(r"[;\n]", text or ""):
        part = part.strip()
        if part:
            rules.append(Rule(part))
    return rules


def load_rules() -> list[Rule]:
    """DEFAULT_RULES overlaid with RTPU_SLO_RULES (same-name replaces;
    a rule that fails to parse is skipped rather than killing the
    sampler — staticcheck lints the in-tree ones)."""
    from ray_tpu_torch._private import flags

    by_name: "dict[str, Rule]" = {}
    for text in DEFAULT_RULES:
        r = Rule(text)
        by_name[r.name] = r
    for part in re.split(r"[;\n]", flags.get("RTPU_SLO_RULES") or ""):
        part = part.strip()
        if not part:
            continue
        try:
            r = Rule(part)
        except RuleError:
            continue
        by_name[r.name] = r
    return list(by_name.values())


# Engine span name -> attribution phase.  The verdict names answer the
# operator question directly: WHERE did the breaching window's latency go.
_PHASE_BY_SPAN = {
    "llm.queue": "queue",
    "llm.kv_pull": "kv_pull",
    "llm.prefill": "prefill",
    "llm.decode": "decode",
}
_VERDICT_BY_PHASE = {
    "queue": "queue_bound",
    "kv_pull": "kv_pull",
    "prefill": "cold_prefill",
    "decode": "decode_contention",
}


def attribute_burn(spans) -> Optional[dict]:
    """Decompose a breaching window's serving latency into phase shares
    from banked engine spans (pure function; the head's sampler feeds it
    the nodes' ``spans_window`` output when an ``slo.fire`` lands on a
    serving-latency rule).

    Returns ``{"phases": {phase: share}, "verdict": str,
    "exemplar_trace_ids": [...], "traces": n}`` or None when no engine
    span in the window maps to a phase.  Shares are fractions of the
    total time spent across the four phases; the verdict is the dominant
    phase; exemplars are the 3 traces that spent the most pre-decode time
    (queue + kv_pull + prefill) — the requests worth pulling up in
    ``rtpu trace`` to see WHY the objective burned."""
    phase_tot = {p: 0.0 for p in _VERDICT_BY_PHASE}
    per_trace: dict[str, dict] = {}
    for s in spans or ():
        phase = _PHASE_BY_SPAN.get(s.get("name"))
        if phase is None:
            continue
        dur = s.get("run_s")
        if dur is None:
            dur = max(0.0, float(s.get("end_ts", 0.0))
                      - float(s.get("start_ts", 0.0)))
        dur = max(0.0, float(dur))
        phase_tot[phase] += dur
        tid = s.get("trace_id")
        if tid:
            t = per_trace.setdefault(str(tid),
                                     {p: 0.0 for p in _VERDICT_BY_PHASE})
            t[phase] += dur
    total = sum(phase_tot.values())
    if total <= 0:
        return None
    phases = {p: round(v / total, 4) for p, v in phase_tot.items()}
    verdict = _VERDICT_BY_PHASE[
        max(phase_tot, key=lambda p: phase_tot[p])]
    ranked = sorted(
        per_trace.items(),
        key=lambda kv: -(kv[1]["queue"] + kv[1]["kv_pull"]
                         + kv[1]["prefill"]))
    return {"phases": phases, "verdict": verdict,
            "exemplar_trace_ids": [tid for tid, _ in ranked[:3]],
            "traces": len(per_trace)}


class SLOEngine:
    """Multi-window burn-rate state machine over a TSDB."""

    def __init__(self, rules: Optional[list] = None, sample_s: float = 1.0,
                 fast_fraction: float = 0.2, clear_ratio: float = 0.9,
                 clear_ticks: int = 3):
        self.rules = list(load_rules() if rules is None else rules)
        self.sample_s = float(sample_s)
        self.fast_fraction = float(fast_fraction)
        self.clear_ratio = float(clear_ratio)
        self.clear_ticks = max(1, int(clear_ticks))
        self._state: dict[str, dict] = {
            r.name: {"firing": False, "since": None, "ok_ticks": 0,
                     "value": None, "burn_fast": 0.0, "burn_slow": 0.0,
                     "fired_total": 0, "attribution": None}
            for r in self.rules}

    def note_attribution(self, rule_name: str, attribution) -> None:
        """Bank a fire-time phase-share attribution (from
        :func:`attribute_burn`) so ``rtpu slo --explain`` can replay the
        verdict after the alert event has scrolled by."""
        st = self._state.get(rule_name)
        if st is not None:
            st["attribution"] = attribution

    def fast_window(self, rule: Rule) -> float:
        return max(2.0 * self.sample_s,
                   rule.window_s * self.fast_fraction)

    def tick(self, tsdb, now: Optional[float] = None) -> list[dict]:
        """Evaluate every rule once; returns alert-transition events
        (ready for the events_push lane)."""
        now = time.time() if now is None else float(now)
        transitions: list[dict] = []
        for rule in self.rules:
            st = self._state[rule.name]
            v_slow = rule.value(tsdb, rule.window_s, now)
            v_fast = rule.value(tsdb, self.fast_window(rule), now)
            b_slow = rule.burn(v_slow)
            b_fast = rule.burn(v_fast)
            st["value"] = v_slow
            st["burn_slow"] = 0.0 if b_slow is None else b_slow
            st["burn_fast"] = 0.0 if b_fast is None else b_fast
            if not st["firing"]:
                if (b_fast is not None and b_slow is not None
                        and b_fast > 1.0 and b_slow > 1.0):
                    st.update(firing=True, since=now, ok_ticks=0)
                    st["fired_total"] += 1
                    transitions.append({
                        "ts": now, "kind": "slo.fire", "severity": "error",
                        "message": f"SLO {rule.name} breached: "
                                   f"{rule.text} (value={v_slow:.6g}, "
                                   f"burn fast={b_fast:.2f} "
                                   f"slow={b_slow:.2f})",
                        "data": {"rule": rule.name, "text": rule.text,
                                 "value": v_slow, "burn_fast": b_fast,
                                 "burn_slow": b_slow},
                    })
            else:
                if (b_fast or 0.0) < self.clear_ratio:
                    st["ok_ticks"] += 1
                    if st["ok_ticks"] >= self.clear_ticks:
                        dur = now - (st["since"] or now)
                        st.update(firing=False, since=None, ok_ticks=0)
                        transitions.append({
                            "ts": now, "kind": "slo.clear",
                            "severity": "info",
                            "message": f"SLO {rule.name} recovered after "
                                       f"{dur:.1f}s",
                            "data": {"rule": rule.name, "text": rule.text,
                                     "duration_s": dur},
                        })
                else:
                    st["ok_ticks"] = 0
        return transitions

    def status(self) -> dict:
        rows = []
        for rule in self.rules:
            st = self._state[rule.name]
            rows.append({
                "rule": rule.name, "text": rule.text,
                "objective": f"{self.describe_expr(rule)} {rule.op} "
                             f"{rule.threshold:g}",
                "window_s": rule.window_s,
                "fast_window_s": self.fast_window(rule),
                "value": st["value"],
                "burn_fast": st["burn_fast"],
                "burn_slow": st["burn_slow"],
                "firing": st["firing"],
                "since": st["since"],
                "fired_total": st["fired_total"],
                "attribution": st.get("attribution"),
            })
        return {"rules": rows,
                "healthy": not any(r["firing"] for r in rows)}

    @staticmethod
    def describe_expr(rule: Rule) -> str:
        def term(t: _Term) -> str:
            return f"{t.func}({t.family}, {t.window_s:g}s)"

        if rule.den is None:
            return term(rule.num)
        return f"{term(rule.num)} / {term(rule.den)}"


def status_metrics(status: dict) -> list[dict]:
    """Synthesize the slo_burn_rate / slo_healthy gauge snapshots in the
    util.metrics push shape, so the burn state rides the normal
    metrics_push lane and lands on /metrics and in the TSDB itself."""
    burn_vals = {}
    healthy_vals = {}
    for r in status.get("rules", ()):
        burn_vals[(r["rule"], "fast")] = float(r["burn_fast"])
        burn_vals[(r["rule"], "slow")] = float(r["burn_slow"])
        healthy_vals[(r["rule"],)] = 0.0 if r["firing"] else 1.0
    healthy_vals[("all",)] = 1.0 if status.get("healthy") else 0.0
    return [
        {"name": "slo_burn_rate", "kind": "gauge",
         "description": "Current SLO burn rate per rule and window "
                        "(>1 = objective being violated)",
         "tag_keys": ("rule", "window"), "values": burn_vals},
        {"name": "slo_healthy", "kind": "gauge",
         "description": "1 when the SLO rule is not firing (rule='all' "
                        "aggregates; the autoscaler consumes this)",
         "tag_keys": ("rule",), "values": healthy_vals},
    ]
