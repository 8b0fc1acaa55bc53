"""Byte tokenizer, copied from deeppowers_tpu/serving/tokenizer.py:86
(`ByteTokenizer`, host-only): ids 4..259 are bytes 0..255; 0..3 are
pad/eos/bos/unk. It serves text on this slice's path; the BPE and
HuggingFace tokenizers are not ported yet."""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    """ids 4..259 are bytes 0..255; 0..3 are pad/eos/bos/unk."""

    _OFFSET = 4
    pad_token_id = 0
    eos_token_id = 1
    bos_token_id = 2
    unk_token_id = 3

    def encode(self, text: str) -> List[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 260
