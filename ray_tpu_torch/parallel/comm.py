"""Analytic per-axis collective-volume estimator (the ICI comm bound).

A copy of ``ray_tpu/parallel/comm.py``: pure arithmetic, and its results
equal the JAX package's exactly.  The rest of this docstring is the
original's.

ROADMAP item 4 asks for the "ICI comm-volume bound" before any further
training-perf work, and EQuARX (PAPERS.md 2506.17615) only pays off if the
per-axis all-reduce byte volume is known first.  This module computes that
bound WITHOUT running a model: it walks the mesh axis sizes plus the
repo's default sharding scheme (params/grads over ``fsdp``, gradient
replicas over ``dp``/``dcn``, attention-head/MLP shards over ``tp``,
sequence shards over ``sp`` — parallel/sharding.py DEFAULT_RULES) and
reports the expected all-gather / reduce-scatter / all-reduce bytes per
device per step for a dense transformer LM.  Pure arithmetic, so it runs
on CPU CI and backs ``rtpu comm``.

Counting rules (ring algorithms, the ICI lower bound; B=global batch,
S=sequence, d=d_model, L=layers, P=param count, b=dtype bytes; axis sizes
F=fsdp, D=dp, C=dcn, T=tp, Sp=sp):

* ``fsdp`` — ZeRO-3 style: parameters live sharded and are re-gathered
  around each use, gradients are reduce-scattered back.
  - all-gather params, forward:   P·b·(F-1)/F
  - all-gather params, backward:  P·b·(F-1)/F
  - reduce-scatter grads:         P·b·(F-1)/F
* ``dp`` / ``dcn`` — plain replica gradient all-reduce over the
  fsdp-sharded gradient (each device holds P·b/F after reduce-scatter):
  - all-reduce grads:             2·(P·b/F)·(D-1)/D   (and C likewise)
* ``tp`` — Megatron pattern, 2 activation all-reduces per layer forward
  (attention output projection + MLP down projection) and 2 backward,
  each over the device-local activation a = (B/(C·D·F))·(S/Sp)·d·b:
  - all-reduce activations:       4·L events of 2·a·(T-1)/T
* ``sp`` — ring attention K/V exchange, 2 all-gathers per layer forward
  (K and V) + 2 backward over k = (B/(C·D·F))·(S/Sp)·d_kv·b:
  - all-gather kv:                4·L events of k·(Sp-1)/Sp

The vocab-parallel logits all-reduce and pipeline (``pp``/``ep``)
point-to-point traffic are intentionally out of scope — they are either
small (softmax stats) or not collective-shaped; the estimator documents a
floor, not a cycle-accurate simulation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Link-rate defaults for the optional time bound: v5e ICI is ~1600 Gb/s
# aggregate per chip (~200 GB/s), but a single ring direction on one axis
# sees roughly 45 GB/s/link on v5e; DCN is host NIC territory.
DEFAULT_ICI_GBPS = 45.0
DEFAULT_DCN_GBPS = 12.5

_COLLECTIVE_AXES = ("dcn", "dp", "fsdp", "sp", "tp")


@dataclass(frozen=True)
class CommEvent:
    """One class of collective traffic on one mesh axis."""

    axis: str            # mesh axis the collective runs over
    op: str              # all_gather | reduce_scatter | all_reduce
    what: str            # params | grads | activations | kv
    events_per_step: int
    bytes_per_event: float   # per device, ring lower bound
    lowers: str = ""     # human note: which formula produced it

    @property
    def bytes_per_step(self) -> float:
        return self.events_per_step * self.bytes_per_event


def _ring_ag(nbytes: float, ax: int) -> float:
    """All-gather / reduce-scatter ring volume per device."""
    return nbytes * (ax - 1) / ax


def _ring_ar(nbytes: float, ax: int) -> float:
    """All-reduce = reduce-scatter + all-gather."""
    return 2.0 * nbytes * (ax - 1) / ax


def estimate_train_comm(
    axes: Dict[str, int],
    *,
    n_params: int,
    n_layers: int,
    d_model: int,
    batch: int,
    seq: int,
    dtype_bytes: int = 2,
    d_kv: Optional[int] = None,
) -> List[CommEvent]:
    """Expected collective bytes per device per training step.

    ``axes`` maps mesh axis name -> size (missing axes default to 1, size-1
    axes emit nothing).  ``batch`` is the GLOBAL batch; the local
    activation operand is derived by dividing out the batch-sharded axes.
    """
    ax = {a: int(axes.get(a, 1) or 1) for a in
          ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")}
    for a, v in ax.items():
        if v < 1:
            raise ValueError(f"axis {a} size must be >= 1, got {v}")
    if n_params <= 0 or n_layers <= 0 or d_model <= 0:
        raise ValueError("n_params, n_layers, d_model must be positive")
    batch_shards = ax["dcn"] * ax["dp"] * ax["fsdp"]
    if batch % batch_shards:
        raise ValueError(
            f"global batch {batch} not divisible by dcn*dp*fsdp"
            f"={batch_shards}")
    if seq % ax["sp"]:
        raise ValueError(f"seq {seq} not divisible by sp={ax['sp']}")

    P = float(n_params) * dtype_bytes
    F, D, C, T, Sp = ax["fsdp"], ax["dp"], ax["dcn"], ax["tp"], ax["sp"]
    grad_shard = P / F                      # grads after fsdp reduce-scatter
    act = (batch / batch_shards) * (seq / Sp) * d_model * dtype_bytes
    kv = (batch / batch_shards) * (seq / Sp) * (d_kv or d_model) \
        * dtype_bytes

    events: List[CommEvent] = []
    if F > 1:
        events.append(CommEvent(
            "fsdp", "all_gather", "params", 2, _ring_ag(P, F),
            "fwd+bwd param re-gather: P*b*(F-1)/F each"))
        events.append(CommEvent(
            "fsdp", "reduce_scatter", "grads", 1, _ring_ag(P, F),
            "grad shard-back: P*b*(F-1)/F"))
    for name, size in (("dp", D), ("dcn", C)):
        if size > 1:
            events.append(CommEvent(
                name, "all_reduce", "grads", 1, _ring_ar(grad_shard, size),
                "replica grad sync: 2*(P*b/F)*(ax-1)/ax"))
    if T > 1:
        events.append(CommEvent(
            "tp", "all_reduce", "activations", 4 * n_layers,
            _ring_ar(act, T),
            "attn-out + mlp-down, fwd+bwd: 2*a*(T-1)/T each"))
    if Sp > 1:
        events.append(CommEvent(
            "sp", "all_gather", "kv", 4 * n_layers, _ring_ag(kv, Sp),
            "ring-attention K/V, fwd+bwd: k*(Sp-1)/Sp each"))
    return events


@dataclass
class CommSummary:
    per_axis_bytes: Dict[str, float] = field(default_factory=dict)
    total_bytes: float = 0.0
    per_axis_seconds: Dict[str, float] = field(default_factory=dict)
    bound_seconds: float = 0.0   # serialized lower bound (sum of axes)


def summarize(events: List[CommEvent],
              ici_gbps: float = DEFAULT_ICI_GBPS,
              dcn_gbps: float = DEFAULT_DCN_GBPS) -> CommSummary:
    """Per-axis byte totals + a per-step time lower bound.

    The time bound assumes each axis' traffic serializes at its link rate
    (ICI for on-slice axes, DCN for ``dcn``) with zero overlap — the
    pessimistic floor a perf PR has to beat before quantized collectives
    (EQuARX) are worth the complexity.
    """
    s = CommSummary()
    for ev in events:
        s.per_axis_bytes[ev.axis] = (s.per_axis_bytes.get(ev.axis, 0.0)
                                     + ev.bytes_per_step)
    s.total_bytes = sum(s.per_axis_bytes.values())
    for axis, nbytes in s.per_axis_bytes.items():
        rate = dcn_gbps if axis == "dcn" else ici_gbps
        s.per_axis_seconds[axis] = nbytes / (rate * 1e9) if rate > 0 \
            else float("inf")
    s.bound_seconds = sum(s.per_axis_seconds.values())
    return s


# ---------------------------------------------------------------------------
# model presets for the CLI — analytic parameter counts

def gpt2_params(vocab: int = 50257, n_ctx: int = 1024, d_model: int = 768,
                n_layers: int = 12) -> int:
    """GPT-2 style: learned positions, fused qkv, 4x MLP, tied lm head."""
    per_layer = (3 * d_model * d_model + d_model      # qkv
                 + d_model * d_model + d_model        # attn out proj
                 + 8 * d_model * d_model + 5 * d_model  # mlp up+down
                 + 4 * d_model)                       # 2 layernorms
    return (vocab * d_model + n_ctx * d_model
            + n_layers * per_layer + 2 * d_model)


def llama_params(vocab: int, d_model: int, n_layers: int, d_ff: int,
                 n_heads: int, n_kv_heads: int,
                 tied_embeddings: bool = False) -> int:
    """Llama style: RoPE (no position table), GQA, SwiGLU, RMSNorm."""
    head_dim = d_model // n_heads
    kv_dim = n_kv_heads * head_dim
    per_layer = (d_model * d_model            # q
                 + 2 * d_model * kv_dim       # k, v
                 + d_model * d_model          # o
                 + 3 * d_model * d_ff         # gate, up, down
                 + 2 * d_model)               # 2 rmsnorms
    total = vocab * d_model + n_layers * per_layer + d_model
    if not tied_embeddings:
        total += vocab * d_model              # separate lm head
    return total


MODEL_PRESETS: Dict[str, dict] = {
    "gpt2_124m": {
        "n_params": gpt2_params(),
        "n_layers": 12, "d_model": 768, "d_kv": 768,
        "batch": 32, "seq": 1024,
    },
    "llama3_8b": {
        "n_params": llama_params(vocab=128256, d_model=4096, n_layers=32,
                                 d_ff=14336, n_heads=32, n_kv_heads=8),
        "n_layers": 32, "d_model": 4096, "d_kv": 1024,
        "batch": 16, "seq": 8192,
    },
    "llama3_8b_dry": {
        # the CPU dry-run shape from train/llama3.py (4 layers, d 512)
        "n_params": llama_params(vocab=32000, d_model=512, n_layers=4,
                                 d_ff=1376, n_heads=8, n_kv_heads=4),
        "n_layers": 4, "d_model": 512, "d_kv": 256,
        "batch": 8, "seq": 512,
    },
}


def parse_mesh(spec: str) -> Dict[str, int]:
    """Parse "fsdp=8,tp=2" into an axes dict (CLI helper)."""
    axes: Dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"bad mesh entry {part!r}; want axis=size")
        k, v = part.split("=", 1)
        k = k.strip()
        if k not in ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp"):
            raise ValueError(f"unknown mesh axis {k!r}")
        axes[k] = int(v)
    return axes


def mesh_total(axes: Dict[str, int]) -> int:
    return math.prod(max(1, int(v)) for v in axes.values()) if axes else 1
