"""Power-of-two-choices router (the default policy).

Counterpart of ``ray_tpu/serve/request_router/pow2.py``: sample two
replicas uniformly, send to the less loaded.  Compared to uniform random,
the expected maximum queue drops from Θ(log n / log log n) to
Θ(log log n) for two load lookups.
"""

from __future__ import annotations

import random
from typing import Optional

from ray_tpu_torch.serve.request_router.base import RequestRouter


class Pow2Router(RequestRouter):
    policy = "pow2"

    def choose(self, hint: Optional[str] = None):
        reps = self._require_replicas()
        if len(reps) == 1:
            self._record("single")
            return reps[0]
        a, b = random.sample(reps, 2)
        pick = a if self.load(a.actor_id) <= self.load(b.actor_id) else b
        self._record("pow2", reps)
        return pick
