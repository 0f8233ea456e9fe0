"""``ray_tpu_torch.data.llm``: Ray's ``ray.data.llm`` import path.

Counterpart of ``ray_tpu/data/llm.py``.  The implementation lives in
``ray_tpu_torch.llm.batch`` (the engine and its stages are LLM concerns);
this alias mirrors Ray's public module layout.
"""

from ray_tpu_torch.llm.batch import ProcessorConfig, build_llm_processor

__all__ = ["ProcessorConfig", "build_llm_processor"]
