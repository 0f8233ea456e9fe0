"""OpenAI-compatible LLM serving over the port's engine.

Counterpart of ``ray_tpu/llm/server.py``: an ``LLMServer`` owns one
continuous-batching engine (``llm/engine.py``) and answers
``/v1/completions`` and ``/v1/chat/completions`` bodies, whole or as SSE
streams; ``OpenAIRouter`` is the path-aware ingress that maps an HTTP-shaped
request dict onto a handle to an ``LLMServer``.  The handle is anything with
``.options(routing_hint=...).<method>.remote(...).result(timeout_s=...)``:
a serve deployment handle, or an in-process stand-in.  ``build_openai_app``
binds both as a serve application: ``LLMServer`` replicas behind the
prefix-aware router, each an actor of the port's runtime holding its engine
on ``LLMConfig.device`` in its own process.
"""

from __future__ import annotations

import json
import queue as queue_mod
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch import serve
from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.llm import kv_tier as kv_tier_mod
from ray_tpu_torch.llm.engine import EngineConfig, LLMEngine, SamplingParams
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.serve import StreamingResponse
from ray_tpu_torch.util import tracing


@dataclass
class LLMConfig:
    """Model loading, engine and replica settings of one served model."""

    model_id: str = "llama-tiny"
    # callable returning (state, LlamaConfig) — the checkpoint loading hook
    model_loader: Optional[Callable] = None
    tokenizer: Optional[str] = None  # None/"byte" or HF name
    engine_config: EngineConfig = field(default_factory=EngineConfig)
    default_max_tokens: int = 64
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    device: DeviceLike = None  # None: CUDA; "cpu" runs the plain versions


def make_engine(llm_config: LLMConfig, kv_tier=None) -> LLMEngine:
    """Load the model and start an engine for it on the config's device."""
    if llm_config.model_loader is None:
        raise ValueError("LLMConfig.model_loader is required")
    state, model_cfg = llm_config.model_loader()
    engine = LLMEngine(state, model_cfg, llm_config.engine_config,
                       kv_tier=kv_tier, device=llm_config.device)
    engine.start()
    return engine


def drain(req, timeout_s: float = 300.0) -> List[int]:
    """Every token of one engine request, raising what the engine put."""
    toks: List[int] = []
    while True:
        item = req.out_queue.get(timeout=timeout_s)
        if item is None:
            return toks
        if isinstance(item, Exception):
            raise item
        toks.append(item)


class LLMServer:
    """The engine-owning deployment (one engine per replica)."""

    def __init__(self, llm_config: LLMConfig):
        self._config = llm_config
        self._tok = get_tokenizer(llm_config.tokenizer)
        # Store-backed KV tier: in a replica of the port's runtime the engine
        # seals hot family spines into the shm store and pulls them back on
        # sheds/failover instead of cold-prefilling (or a tier installed
        # with kv_tier.set_default_tier).
        self._tier = kv_tier_mod.default_tier()
        self._engine = make_engine(llm_config, self._tier)
        if self._tier is not None:
            # Warm restart: a replica the controller just restarted (or a
            # fresh scale-up) re-hydrates the cluster's hottest families
            # from the store before traffic arrives.  Asynchronous (the
            # scheduler thread drains the queue); an empty directory is a
            # no-op.
            roots = self._tier.hottest(8)
            if roots:
                self._engine.kv_prehydrate(roots)

    def _params_from(self, body: dict) -> SamplingParams:
        stop_ids = tuple(body.get("stop_token_ids", ()))
        eos = getattr(self._tok, "eos_id", None)
        if eos is not None and not body.get("ignore_eos"):
            stop_ids = stop_ids + (eos,)
        return SamplingParams(
            max_tokens=int(body.get("max_tokens",
                                    self._config.default_max_tokens)),
            temperature=float(body.get("temperature", 0.0)),
            top_p=float(body.get("top_p", 1.0)),
            stop_token_ids=stop_ids,
            seed=body.get("seed"))

    def _encode_prompt(self, prompt) -> List[int]:
        return (list(prompt) if isinstance(prompt, list)
                and prompt and isinstance(prompt[0], int)
                else self._tok.encode(str(prompt)))

    def _sse_stream(self, tokens: List[int], params: SamplingParams,
                    rid: str, model: str, chat: bool, trace_ctx=None):
        """Token stream -> OpenAI SSE chunks (the engine already streams
        per-request token queues)."""
        obj = "chat.completion.chunk" if chat else "text_completion"
        try:
            # the generator body runs lazily on whichever thread pulls it:
            # restore the captured context so the engine request parents
            # under the caller's span
            with tracing.use_context(trace_ctx):
                req = self._engine.submit(tokens, params)
        except Exception as e:  # noqa: BLE001 — frame submit rejections
            yield ("data: " + json.dumps(
                {"error": {"message": f"{type(e).__name__}: {e}"}}) + "\n\n")
            yield "data: [DONE]\n\n"
            return
        if chat:
            first = {"id": rid, "object": obj, "created": int(time.time()),
                     "model": model,
                     "choices": [{"index": 0, "delta": {"role": "assistant"},
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(first)}\n\n"
        n = 0
        deadline = time.monotonic() + 600.0
        while True:
            try:
                # bounded waits: a dead engine loop pushes no terminator,
                # and a stream must never hang its puller
                tok = req.out_queue.get(timeout=5.0)
            except queue_mod.Empty:
                thread = self._engine._thread
                if ((thread is not None and not thread.is_alive()
                     and not self._engine._stop.is_set())
                        or time.monotonic() > deadline):
                    yield ("data: " + json.dumps({"error": {
                        "message": "engine stopped mid-stream"}}) + "\n\n")
                    break
                continue
            if isinstance(tok, Exception):
                err = {"error": {"message": str(tok)}}
                yield f"data: {json.dumps(err)}\n\n"
                break
            if tok is None:
                reason = "length" if n >= params.max_tokens else "stop"
                delta = ({"delta": {}} if chat else {"text": ""})
                final = {"id": rid, "object": obj,
                         "created": int(time.time()), "model": model,
                         "choices": [{"index": 0, **delta,
                                      "finish_reason": reason}]}
                yield f"data: {json.dumps(final)}\n\n"
                break
            n += 1
            piece = self._tok.decode([tok])
            payload = ({"delta": {"content": piece}} if chat
                       else {"text": piece})
            chunk = {"id": rid, "object": obj, "created": int(time.time()),
                     "model": model,
                     "choices": [{"index": 0, **payload,
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(chunk)}\n\n"
        yield "data: [DONE]\n\n"

    def completions_stream(self, body: dict) -> StreamingResponse:
        tokens = self._encode_prompt(body.get("prompt", ""))
        return StreamingResponse(
            self._sse_stream(tokens, self._params_from(body),
                             f"cmpl-{uuid.uuid4().hex[:24]}",
                             body.get("model", self._config.model_id),
                             chat=False,
                             trace_ctx=tracing.current_context()),
            content_type="text/event-stream")

    def chat_stream(self, body: dict) -> StreamingResponse:
        prompt = self._tok.apply_chat_template(body.get("messages", []))
        return StreamingResponse(
            self._sse_stream(self._tok.encode(prompt),
                             self._params_from(body),
                             f"chatcmpl-{uuid.uuid4().hex[:24]}",
                             body.get("model", self._config.model_id),
                             chat=True,
                             trace_ctx=tracing.current_context()),
            content_type="text/event-stream")

    def _response(self, obj: str, rid: str, body: dict, tokens: List[int],
                  out: List[int], params: SamplingParams,
                  choice: dict) -> dict:
        reason = "stop" if len(out) < params.max_tokens else "length"
        return {
            "id": rid, "object": obj, "created": int(time.time()),
            "model": body.get("model", self._config.model_id),
            "choices": [{"index": 0, **choice, "finish_reason": reason}],
            "usage": {"prompt_tokens": len(tokens),
                      "completion_tokens": len(out),
                      "total_tokens": len(tokens) + len(out)},
        }

    def completions(self, body: dict) -> dict:
        tokens = self._encode_prompt(body.get("prompt", ""))
        params = self._params_from(body)
        out = self._engine.generate(tokens, params)
        return self._response(
            "text_completion", f"cmpl-{uuid.uuid4().hex[:24]}", body,
            tokens, out, params, {"text": self._tok.decode(out)})

    def chat(self, body: dict) -> dict:
        prompt = self._tok.apply_chat_template(body.get("messages", []))
        tokens = self._tok.encode(prompt)
        params = self._params_from(body)
        out = self._engine.generate(tokens, params)
        return self._response(
            "chat.completion", f"chatcmpl-{uuid.uuid4().hex[:24]}", body,
            tokens, out, params,
            {"message": {"role": "assistant",
                         "content": self._tok.decode(out)}})

    def generate_tokens(self, prompt_tokens: List[int],
                        **params) -> List[int]:
        """Raw token API (batch inference)."""
        return self._engine.generate(list(prompt_tokens),
                                     SamplingParams(**params))

    def engine_stats(self) -> dict:
        return self._engine.stats()

    def kv_prehydrate(self, roots) -> int:
        """Pull these family spines from the KV tier (no-op without a
        tier)."""
        roots = list(roots)
        self._engine.kv_prehydrate(roots)
        return len(roots)

    def check_health(self):
        if self._engine._thread is not None \
                and not self._engine._thread.is_alive() \
                and not self._engine._stop.is_set():
            raise RuntimeError("engine loop died")

    def shutdown(self) -> None:
        """Stop the engine's scheduler thread."""
        self._engine.stop()


class OpenAIRouter:
    """Path-aware ingress translating OpenAI REST to LLMServer calls."""

    def __init__(self, server_handle, model_id: str):
        self._server = server_handle
        self._model_id = model_id

    @staticmethod
    def _hint(body: dict, chat: bool) -> Optional[str]:
        """Routing hint for a prefix-aware router: the raw prompt text
        prefix (no tokenizer needed here).  Chat requests hint on the
        concatenated message contents, so multi-turn conversations sharing
        a history keep landing on the replica that holds their KV pages."""
        if chat:
            parts = []
            for m in body.get("messages", []) or []:
                parts.append(str(m.get("role", "")))
                parts.append(str(m.get("content", "")))
            text = "\x1f".join(parts)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = ",".join(str(t) for t in prompt)
            text = str(prompt)
        return text[:512] or None

    def handle_http(self, request: dict):
        path = request.get("path", "/")
        body = request.get("body") or {}
        if path.endswith("/v1/models") or path == "/models":
            return {"object": "list",
                    "data": [{"id": self._model_id, "object": "model"}]}
        # Trace root for the serving anatomy: every request that survives
        # RTPU_TRACE_SAMPLE renders as one connected tree — openai.request
        # -> llm.request (queue / kv_pull / prefill / decode under it).
        if path.endswith("/chat/completions"):
            with tracing.serving_span("openai.request", path=path,
                                      stream=bool(body.get("stream"))):
                h = self._server.options(
                    routing_hint=self._hint(body, True))
                if body.get("stream"):
                    return h.chat_stream.remote(body).result(timeout_s=300)
                return h.chat.remote(body).result(timeout_s=300)
        if path.endswith("/completions"):
            with tracing.serving_span("openai.request", path=path,
                                      stream=bool(body.get("stream"))):
                h = self._server.options(
                    routing_hint=self._hint(body, False))
                if body.get("stream"):
                    return h.completions_stream.remote(body).result(
                        timeout_s=300)
                return h.completions.remote(body).result(timeout_s=300)
        return {"error": f"unknown endpoint {path}"}


def build_openai_app(llm_config: LLMConfig) -> serve.Application:
    """``LLMServer`` replicas behind the ``OpenAIRouter`` ingress (the
    reference's builders/application_builders.py build_openai_app)."""
    server = serve.deployment(LLMServer).options(
        name=f"LLMServer:{llm_config.model_id}",
        num_replicas=llm_config.num_replicas,
        ray_actor_options=llm_config.ray_actor_options,
        max_ongoing_requests=llm_config.engine_config.max_slots * 2,
        # KV-locality routing: keep shared prompt prefixes (system prompts,
        # multi-turn histories) on the replica holding their warm pages
        request_router_policy="prefix_aware",
    ).bind(llm_config)
    router = serve.deployment(OpenAIRouter).options(
        name="OpenAIRouter").bind(server, llm_config.model_id)
    return router
