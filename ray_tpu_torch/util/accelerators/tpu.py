"""TPU generation/topology facts + pod environment helpers.

A copy of ``ray_tpu/util/accelerators/tpu.py`` (Ray's
python/ray/util/accelerators/tpu.py pod helpers and the environment
conventions of _private/accelerators/tpu.py): a slice is an atomic,
SHAPED gang (2x2x1 vs 4x2 are different machines even at equal chip
counts), and these helpers hold the generation facts that scheduling,
the autoscaler's node-type shapes and mesh construction need.  The port
runs on GPUs (``gpu.py`` describes their node); these facts stay for
clusters and configurations that name TPU shapes.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

# chips per host by generation: v2-v4 + v5p host 4 chips; v5e + v6e host 8
CHIPS_PER_HOST = {
    "v2": 4, "v3": 4, "v4": 4, "v5p": 4,
    "v5litepod": 8, "v5e": 8, "v6e": 8,
}
# tensorcores per chip: v5e/v6e are single-core; older gens dual-core
CORES_PER_CHIP = {
    "v2": 2, "v3": 2, "v4": 2, "v5p": 2,
    "v5litepod": 1, "v5e": 1, "v6e": 1,
}
VALID_TPU_TYPES = tuple(CHIPS_PER_HOST)

# environment set by the TPU runtime / GKE on pod workers
TPU_NAME_ENV = "TPU_NAME"
TPU_WORKER_ID_ENV = "TPU_WORKER_ID"
TPU_ACCELERATOR_TYPE_ENV = "TPU_ACCELERATOR_TYPE"
TPU_WORKER_HOSTNAMES_ENV = "TPU_WORKER_HOSTNAMES"
TPU_VISIBLE_CHIPS_ENV = "TPU_VISIBLE_CHIPS"


def parse_accelerator_type(accelerator_type: str) -> tuple[str, int]:
    """"v5litepod-16" -> ("v5litepod", 16). The count is in GCP's naming
    unit: TENSORCORES for dual-core generations (v2-v4, v5p) and CHIPS for
    single-core ones (v5e/v6e) — use chips_in_slice() for chip math."""
    gen, _, count = accelerator_type.partition("-")
    if gen not in CHIPS_PER_HOST or not count.isdigit():
        raise ValueError(
            f"invalid TPU accelerator type {accelerator_type!r}; expected "
            f"<generation>-<count> with generation in {VALID_TPU_TYPES}")
    return gen, int(count)


def chips_in_slice(accelerator_type: str) -> int:
    """Physical chips in a slice: "v4-16" = 16 cores = 8 chips;
    "v5litepod-16" = 16 chips."""
    gen, count = parse_accelerator_type(accelerator_type)
    return max(1, count // CORES_PER_CHIP[gen])


def num_chips_per_host(generation_or_type: str) -> int:
    gen = generation_or_type.partition("-")[0]
    try:
        return CHIPS_PER_HOST[gen]
    except KeyError:
        raise ValueError(f"unknown TPU generation {gen!r}") from None


def num_hosts_in_slice(accelerator_type: str) -> int:
    """Hosts a slice spans ("v5litepod-16" -> 2 hosts of 8 chips;
    "v4-16" -> 8 chips -> 2 hosts)."""
    gen, _ = parse_accelerator_type(accelerator_type)
    chips = chips_in_slice(accelerator_type)
    return max(1, -(-chips // CHIPS_PER_HOST[gen]))


def get_current_pod_name() -> Optional[str]:
    """The TPU pod/slice this process runs in (None off-TPU).

    Reference: ray.util.accelerators.tpu.get_current_pod_name.
    """
    return os.environ.get(TPU_NAME_ENV) or None


def get_current_pod_worker_count() -> Optional[int]:
    """Number of hosts in the current slice (None off-TPU)."""
    hostnames = os.environ.get(TPU_WORKER_HOSTNAMES_ENV)
    if hostnames:
        return len(hostnames.split(","))
    atype = os.environ.get(TPU_ACCELERATOR_TYPE_ENV)
    if atype:
        try:
            return num_hosts_in_slice(atype)
        except ValueError:
            return None
    return None


def get_num_tpu_chips_on_node() -> int:
    """Chips visible to this host: ``RAY_TPU_NUM_CHIPS`` if set, else the
    ``/dev/accel*`` devices (0 off-TPU).  The JAX package also asks JAX's
    devices; the port imports no JAX."""
    env = os.environ.get("RAY_TPU_NUM_CHIPS")
    if env is not None:
        return int(env)
    return len(glob.glob("/dev/accel*"))


def pod_head_resource(accelerator_type: str) -> str:
    """The marker resource name gang-scheduling uses to place one task per
    slice (reference: TPU-{version}-head, _private/accelerators/tpu.py:353).
    """
    gen, _ = parse_accelerator_type(accelerator_type)
    return f"TPU-{gen}-head"
