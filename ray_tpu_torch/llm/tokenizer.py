"""Byte tokenizer for the serving stack.

Counterpart of ``ray_tpu/llm/tokenizer.py``'s ``ByteTokenizer``: a
dependency-free reversible byte tokenizer that works with randomly
initialised models and machines without network access.
"""

from __future__ import annotations

from typing import List


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
