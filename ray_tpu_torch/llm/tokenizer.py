"""Tokenizers for the serving stack.

Counterpart of ``ray_tpu/llm/tokenizer.py``: a dependency-free reversible
byte tokenizer (the default; it works with randomly initialised models and
machines without network access) and an adapter over a locally available
HuggingFace tokenizer.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """UTF-8 bytes + specials.  ids: 0=pad, 1=bos, 2=eos, byte b -> b+3."""

    vocab_size = 256 + 3
    pad_id, bos_id, eos_id = 0, 1, 2

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return [self.bos_id] + ids if add_bos else ids

    def decode(self, ids: List[int]) -> str:
        # Ids beyond byte range can appear when a model's vocab is padded
        # past 259 (untrained or bucket-rounded vocab): skip, don't crash.
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        return "\n".join(parts) + "\nassistant:"


class HFTokenizer:
    """Adapter over a locally available HuggingFace tokenizer."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.vocab_size = self._tok.vocab_size
        self.eos_id = self._tok.eos_token_id
        self.bos_id = self._tok.bos_token_id
        self.pad_id = self._tok.pad_token_id or 0

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> str:
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        except Exception:  # noqa: BLE001 — a tokenizer without a template
            return ByteTokenizer.apply_chat_template(self, messages)


def get_tokenizer(name: Optional[str] = None):
    """``ByteTokenizer`` for None or "byte", else ``HFTokenizer(name)``."""
    if name is None or name == "byte":
        return ByteTokenizer()
    return HFTokenizer(name)
