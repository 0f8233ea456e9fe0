"""Serving: paged KV cache, cache-aware forwards, continuous-batching
engine, the store-backed KV tier, the OpenAI server, prefill/decode
disaggregation and batch inference.

Exports what ``ray_tpu.llm`` exports; ``build_openai_app`` and
``build_pd_openai_app`` bind serve applications on the port's runtime.
"""

from ray_tpu_torch.llm.batch import ProcessorConfig, build_llm_processor
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.paged_cache import CacheConfig, PageAllocator
from ray_tpu_torch.llm.pd_disagg import (DecodeServer, PDRouter,
                                         PrefillServer, build_pd_openai_app)
from ray_tpu_torch.llm.server import LLMConfig, LLMServer, build_openai_app
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, get_tokenizer

__all__ = [
    "ByteTokenizer",
    "CacheConfig",
    "EngineConfig",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
    "PageAllocator",
    "ProcessorConfig",
    "SamplingParams",
    "DecodeServer",
    "PDRouter",
    "PrefillServer",
    "build_llm_processor",
    "build_openai_app",
    "build_pd_openai_app",
    "get_tokenizer",
]
