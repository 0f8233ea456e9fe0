"""Batch LLM inference over a dataset.

Counterpart of ``ray_tpu/llm/batch.py``: ``build_llm_processor`` returns a
dataset -> dataset callable whose stages are ``map_batches`` ops —
tokenize → engine generate (an actor pool, one engine per actor, each
holding ``num_gpus`` of a card) → detokenize.  It runs over the port's
``ray_tpu_torch.data.Dataset`` (any dataset with ``map`` and
``map_batches`` will do; it imports no data package); ``_EngineUDF`` also
runs alone on a dict of numpy columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.server import drain
from ray_tpu_torch.llm.tokenizer import get_tokenizer


@dataclass
class ProcessorConfig:
    """Model, engine, sampling and pool settings of a batch processor."""

    model_loader: Callable = None  # () -> (state, LlamaConfig)
    tokenizer: Optional[str] = None
    engine_config: EngineConfig = field(default_factory=EngineConfig)
    concurrency: int = 1  # engine actors
    batch_size: int = 16
    sampling: Dict[str, Any] = field(default_factory=dict)
    num_gpus: Optional[float] = None  # each engine actor's share of a card
    # wrap each prompt in the tokenizer's chat template
    apply_chat_template: bool = False
    device: DeviceLike = None  # None: CUDA; "cpu" runs the plain versions


class _EngineUDF:
    """Batch UDF hosting one engine."""

    def __init__(self, config: ProcessorConfig):
        state, model_cfg = config.model_loader()
        self._tok = get_tokenizer(config.tokenizer)
        self._engine = LLMEngine(state, model_cfg, config.engine_config,
                                 device=config.device)
        self._engine.start()
        self._sampling = config.sampling
        self._config = config

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        prompts = [str(p) for p in batch["prompt"]]
        if self._config.apply_chat_template:
            prompts = [self._tok.apply_chat_template(
                [{"role": "user", "content": p}]) for p in prompts]
        eos = getattr(self._tok, "eos_id", None)
        sp = dict(self._sampling)
        if eos is not None:
            # ALWAYS stop at eos, including when the user supplied extra
            # stop ids — matching the server's behaviour
            sp["stop_token_ids"] = tuple(
                sp.get("stop_token_ids", ())) + (eos,)
        reqs = [self._engine.submit(self._tok.encode(p),
                                    SamplingParams(**sp)) for p in prompts]
        token_lists = [drain(r, timeout_s=600) for r in reqs]
        out_batch = dict(batch)
        out_batch["generated_text"] = [self._tok.decode(t)
                                       for t in token_lists]
        out_batch["generated_tokens"] = np.array(
            [np.asarray(t, np.int64) for t in token_lists], dtype=object)
        return out_batch

    def shutdown(self) -> None:
        """Stop the engine's scheduler thread."""
        self._engine.stop()


def build_llm_processor(config: ProcessorConfig,
                        preprocess: Optional[Callable] = None,
                        postprocess: Optional[Callable] = None):
    """Returns dataset -> dataset.  Rows need a "prompt" column (or supply
    ``preprocess`` to create one)."""

    def processor(ds):
        if preprocess is not None:
            ds = ds.map(preprocess)
        ds = ds.map_batches(
            _EngineUDF,
            fn_constructor_args=(config,),
            concurrency=config.concurrency,
            batch_size=config.batch_size,
            num_gpus=config.num_gpus,
            batch_format="numpy")
        if postprocess is not None:
            ds = ds.map(postprocess)
        return ds

    return processor
