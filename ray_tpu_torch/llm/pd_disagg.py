"""Prefill/decode disaggregation: separate servers, real KV handoff.

Counterpart of ``ray_tpu/llm/pd_disagg.py``.  The prefill server's engine
runs ``prefill_extract`` (the prompt pass only; it returns the first
sampled token and the prompt's KV pages), the router forwards them to the
decode server, whose engine injects the pages via ``submit_with_kv`` and
continues decoding without recomputing the prompt: prefill (compute-bound)
and decode (memory-bound, latency-sensitive) scale apart.  With a KV tier
installed (``kv_tier.set_default_tier``) the handoff ships only the prompt:
the prefill admission force-seals the spine into the store and the decode
engine PULLS the pages, prefilling only the last partial block; without a
tier the pages travel as host tensors in the prefill result.

The router takes handles with ``.options(routing_hint=...).<method>
.remote(...).result(timeout_s=...)``; building the serve application
(``build_pd_openai_app`` in the JAX package) needs the serve runtime.
"""

from __future__ import annotations

import contextlib
import time
import uuid
from typing import Optional

from ray_tpu_torch.llm import kv_tier as kv_tier_mod
from ray_tpu_torch.llm.engine import SamplingParams
from ray_tpu_torch.llm.paged_cache import PrefixCache
from ray_tpu_torch.llm.server import LLMConfig, drain, make_engine
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.util import tracing


class _EngineServer:
    """One engine on the config's device, with the default KV tier."""

    def __init__(self, llm_config: LLMConfig):
        self._config = llm_config
        self._tok = get_tokenizer(llm_config.tokenizer)
        self._tier = kv_tier_mod.default_tier()
        self._engine = make_engine(llm_config, self._tier)

    def kv_prehydrate(self, roots) -> int:
        roots = list(roots)
        self._engine.kv_prehydrate(roots)
        return len(roots)

    def engine_stats(self) -> dict:
        return self._engine.stats()

    def shutdown(self) -> None:
        """Stop the engine's scheduler thread."""
        self._engine.stop()


class PrefillServer(_EngineServer):
    """Prefill-only server: one engine, no decode slots used."""

    def prefill(self, prompt: str, params_dict: Optional[dict] = None):
        sp = SamplingParams(**(params_dict or {}))
        tokens = self._tok.encode(prompt)
        with tracing.trace_span("pd.prefill",
                                tokens=len(tokens)) as span:
            first, kv_k, kv_v, n = self._engine.prefill_extract(tokens, sp)
        # page-residency hint for the decode hop: the block-chain digest of
        # the prompt's cacheable prefix (a pure function of the tokens and
        # the page size, so the decode engine that admits these pages
        # advertises the same digest in its prefix_digests)
        digest = PrefixCache.digest_for(
            tokens, self._engine.cfg.page_size)
        out = {"prompt_tokens": tokens, "first_token": first,
               "n_tokens": n, "prefix_digest": digest}
        if span is not None:
            # cross-engine link: the decode hop re-establishes THIS span
            # as its parent, so the handoff renders as one connected tree
            out["trace_id"] = span.trace_id
            out["prefill_span_id"] = span.span_id
        if (self._tier is not None
                and len(tokens) > self._engine.cfg.page_size):
            # KV-tier handoff: the prefill admission already force-sealed
            # this prompt's spine into the store, so the decode hop needs
            # only the prompt — its engine pulls the pages.
            out["kv_in_tier"] = True
        else:
            out["kv_k"], out["kv_v"] = kv_k, kv_v
        return out


class DecodeServer(_EngineServer):
    """Decode server: injects shipped KV, continues generation."""

    def decode(self, prefill_result: dict,
               params_dict: Optional[dict] = None) -> dict:
        sp_kwargs = dict(params_dict or {})
        eos = getattr(self._tok, "eos_id", None)
        if eos is not None:
            stop = tuple(sp_kwargs.get("stop_token_ids", ())) + (eos,)
            sp_kwargs["stop_token_ids"] = stop
        sp = SamplingParams(**sp_kwargs)
        tier_path = (prefill_result.get("kv_in_tier")
                     and "kv_k" not in prefill_result)
        with contextlib.ExitStack() as stack:
            # Linked spans across engines: re-establish the prefill span
            # as this thread's context so pd.decode parents under
            # pd.prefill.
            if prefill_result.get("trace_id"):
                stack.enter_context(tracing.use_context(
                    (prefill_result["trace_id"],
                     prefill_result.get("prefill_span_id"))))
            stack.enter_context(tracing.trace_span(
                "pd.decode", handoff="tier" if tier_path else "host"))
            if tier_path:
                # KV-tier handoff: submit as a NORMAL request — admission
                # pulls the sealed spine from the store and hydrates it, so
                # only the final partial block prefills here.  A pull
                # failure degrades to a cold prefill of the same request
                # (counted, never fatal).
                req = self._engine.submit(
                    prefill_result["prompt_tokens"], sp)
                toks = drain(req)
                return {"tokens": toks, "text": self._tok.decode(toks)}
            req = self._engine.submit_with_kv(
                prefill_result["prompt_tokens"],
                prefill_result["first_token"],
                prefill_result["kv_k"], prefill_result["kv_v"], sp)
            toks = [int(prefill_result["first_token"])]
            if toks[0] in sp.stop_token_ids:
                toks = []
            else:
                toks += drain(req)
            return {"tokens": toks, "text": self._tok.decode(toks)}


class PDRouter:
    """OpenAI-ish ingress: prompt → prefill server → decode server."""

    def __init__(self, prefill_handle, decode_handle, model_id: str,
                 default_max_tokens: int = 64):
        self._prefill = prefill_handle
        self._decode = decode_handle
        self._model_id = model_id
        self._default_max_tokens = default_max_tokens

    def handle_http(self, request: dict):
        path = request.get("path", "/")
        body = request.get("body") or {}
        if path.endswith("/v1/models") or path == "/models":
            return {"object": "list",
                    "data": [{"id": self._model_id, "object": "model"}]}
        if path.endswith("/completions"):
            prompt = body.get("prompt", "")
            if path.endswith("/chat/completions"):
                msgs = body.get("messages", [])
                prompt = "\n".join(
                    f"{m.get('role')}: {m.get('content')}" for m in msgs
                ) + "\nassistant:"
            params = {
                "max_tokens": int(body.get("max_tokens",
                                           self._default_max_tokens)),
                "temperature": float(body.get("temperature", 0.0)),
                "top_p": float(body.get("top_p", 1.0)),
                "seed": body.get("seed"),
            }
            with tracing.serving_span("pd.request", path=path):
                # prefix affinity: the same prompt prefix lands on the same
                # prefill replica
                pre = self._prefill.options(
                    routing_hint=prompt[:64]).prefill.remote(
                        prompt, params).result(timeout_s=300)
                # decode routes on the page-residency digest from the
                # prefill result, not a re-hash of the prompt
                out = self._decode.options(
                    routing_hint=pre.get("prefix_digest") or prompt[:64]
                ).decode.remote(pre, params).result(timeout_s=300)
            return {
                "id": f"cmpl-{uuid.uuid4().hex[:12]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": self._model_id,
                "choices": [{"index": 0, "text": out["text"],
                             "finish_reason": "stop"}],
                "usage": {
                    "prompt_tokens": len(pre["prompt_tokens"]),
                    "completion_tokens": len(out["tokens"]),
                    "total_tokens": (len(pre["prompt_tokens"])
                                     + len(out["tokens"])),
                },
            }
        return {"error": f"unknown endpoint {path}"}
