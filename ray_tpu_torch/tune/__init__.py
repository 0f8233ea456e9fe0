"""ray_tpu_torch.tune: hyperparameter search over the core actor runtime.

Counterpart of ``ray_tpu/tune/``, itself the counterpart of Ray Tune
(Ray's python/ray/tune/): Tuner.fit runs
trial actors under a controller event loop with pluggable searchers
(grid/random + Searcher ABC) and schedulers (ASHA, median stopping, PBT).
"""

from ray_tpu_torch.tune.context import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.searchers import (
    AnnealingSearcher,
    BOHBSearcher,
    GPSearcher,
    OptunaSearch,
    TPESearcher,
)
from ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.tuner import Result, ResultGrid, TuneConfig, Tuner

__all__ = [
    "AnnealingSearcher",
    "BOHBSearcher",
    "GPSearcher",
    "OptunaSearch",
    "TPESearcher",
    "ASHAScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Result",
    "ResultGrid",
    "Searcher",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "quniform",
    "randint",
    "report",
    "uniform",
]
