"""Tokenizers, copied from deeppowers_tpu/serving/tokenizer.py (host-only:
the standard library; `HFTokenizer` imports `tokenizers`, `transformers`
and `jinja2` only when it is built or a Jinja chat template renders).

- `TokenizerBase`: encode / decode (and their batch forms), `save`, and
  `apply_chat_template`: the tokenizer's Jinja template when it has one,
  else a generic role-prefixed rendering ("role: content" lines, then
  "assistant:");
- `ByteTokenizer`: ids 4..259 are bytes 0..255, 0..3 pad / eos / bos /
  unk; `id_to_bytes` feeds the structured-output DFA
  (serving/structured.py `token_bytes`);
- `HFTokenizer`: a local `tokenizer.json` or a transformers directory
  (nothing is downloaded: a path that is neither raises);
- `BPETokenizer`: a trainable byte-level BPE (merges learned by repeated
  most-frequent-pair merging) with save / load;
- `load_tokenizer`: None -> byte; a saved BPE or byte JSON -> that; else
  HFTokenizer.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple


class TokenizerBase:
    """API surface of the reference facade (tokenizer.hpp:50-85)."""

    pad_token_id: int = 0
    eos_token_id: int = 1
    bos_token_id: int = 2
    unk_token_id: int = 3

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def decode_batch(self, batches: Sequence[Sequence[int]]) -> List[str]:
        return [self.decode(b) for b in batches]

    @property
    def vocab_size(self) -> int:
        raise NotImplementedError

    def save(self, path: str) -> None:
        raise NotImplementedError

    # chat template hook: the HF checkpoint's Jinja template when available
    # (HFTokenizer), otherwise a generic role-prefixed rendering
    chat_template: Optional[str] = None

    def apply_chat_template(self, messages: Sequence[dict],
                            add_generation_prompt: bool = True) -> str:
        if self.chat_template:
            import jinja2
            env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
            env.globals["raise_exception"] = _jinja_raise
            tpl = env.from_string(self.chat_template)
            return tpl.render(
                messages=list(messages),
                add_generation_prompt=add_generation_prompt,
                bos_token=getattr(self, "bos_token", "") or "",
                eos_token=getattr(self, "eos_token", "") or "")
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        if add_generation_prompt:
            parts.append("assistant:")
        return "\n".join(parts)


def _token_str(t) -> str:
    """tokenizer_config token entries are strings or AddedToken dicts."""
    if isinstance(t, dict):
        return t.get("content", "")
    return t or ""


def _jinja_raise(msg):
    raise ValueError(msg)


class ByteTokenizer(TokenizerBase):
    """ids 4..259 are bytes 0..255; 0..3 are pad/eos/bos/unk."""

    _OFFSET = 4

    def encode(self, text: str) -> List[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self._OFFSET for i in ids
                     if self._OFFSET <= i < self._OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 260

    def id_to_bytes(self, tid: int):
        """Raw bytes of one id (None = special) — feeds the byte-level
        structured-output DFA (serving/structured.py token_bytes)."""
        if self._OFFSET <= tid < self._OFFSET + 256:
            return bytes([tid - self._OFFSET])
        return None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "byte"}, f)


class HFTokenizer(TokenizerBase):
    """Wraps a HuggingFace tokenizer (tokenizer.json file or transformers
    AutoTokenizer directory)."""

    def __init__(self, path: str):
        self._tok = None
        tk_json = os.path.join(path, "tokenizer.json") if os.path.isdir(path) else path
        try:
            from tokenizers import Tokenizer as _T
            self._tok = _T.from_file(tk_json)
            self._mode = "tokenizers"
        except Exception:
            from transformers import AutoTokenizer
            self._tok = AutoTokenizer.from_pretrained(path)
            self._mode = "transformers"
        for name in ("pad", "eos", "bos", "unk"):
            tid = self._special_id(name)
            if tid is not None:
                setattr(self, f"{name}_token_id", tid)
        # chat template: transformers carries it on the tokenizer; for the
        # raw `tokenizers` path read tokenizer_config.json next to the file
        if self._mode == "transformers":
            self.chat_template = getattr(self._tok, "chat_template", None)
            self.bos_token = getattr(self._tok, "bos_token", "") or ""
            self.eos_token = getattr(self._tok, "eos_token", "") or ""
        else:
            cfg_path = os.path.join(
                path if os.path.isdir(path) else os.path.dirname(path),
                "tokenizer_config.json")
            if os.path.isfile(cfg_path):
                try:
                    with open(cfg_path) as f:
                        tc = json.load(f)
                    self.chat_template = tc.get("chat_template")
                    self.bos_token = _token_str(tc.get("bos_token", ""))
                    self.eos_token = _token_str(tc.get("eos_token", ""))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    pass

    def _special_id(self, name: str) -> Optional[int]:
        if self._mode == "transformers":
            return getattr(self._tok, f"{name}_token_id", None)
        for cand in (f"<{name}>", f"</s>" if name == "eos" else None,
                     "<s>" if name == "bos" else None,
                     "<unk>" if name == "unk" else None):
            if cand:
                tid = self._tok.token_to_id(cand)
                if tid is not None:
                    return tid
        return None

    def encode(self, text: str) -> List[int]:
        if self._mode == "tokenizers":
            return self._tok.encode(text).ids
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))

    @property
    def vocab_size(self) -> int:
        if self._mode == "tokenizers":
            return self._tok.get_vocab_size()
        return len(self._tok)

    def save(self, path: str) -> None:
        if self._mode == "tokenizers":
            self._tok.save(path)
        else:
            self._tok.save_pretrained(path)


class BPETokenizer(TokenizerBase):
    """Minimal trainable byte-level BPE (reference capability:
    tokenizer.hpp:41-44 train/save/load; bpe.cpp merge-rule learning).

    Byte-level base alphabet (like GPT-2) so any text round-trips.
    """

    def __init__(self, merges: Optional[List[Tuple[int, int]]] = None):
        # base vocab: 4 specials + 256 bytes
        self.merges: List[Tuple[int, int]] = merges or []
        self._rebuild()

    def _rebuild(self) -> None:
        self._merge_rank: Dict[Tuple[int, int], int] = {
            pair: i for i, pair in enumerate(self.merges)}
        self._merged_id: Dict[Tuple[int, int], int] = {
            pair: 260 + i for i, pair in enumerate(self.merges)}
        # token id -> byte string
        self._bytes: Dict[int, bytes] = {i + 4: bytes([i]) for i in range(256)}
        for pair, tid in self._merged_id.items():
            self._bytes[tid] = self._tok_bytes(pair[0]) + self._tok_bytes(pair[1])

    def _tok_bytes(self, tid: int) -> bytes:
        return self._bytes.get(tid, b"")

    @classmethod
    def train(cls, corpus: Sequence[str], vocab_size: int = 1000,
              min_freq: int = 2) -> "BPETokenizer":
        """Learn merge rules by iterative most-frequent-pair merging
        (reference: bpe.cpp:25-60 training loop)."""
        tok = cls()
        seqs = [[b + 4 for b in text.encode("utf-8")] for text in corpus]
        target_merges = max(0, vocab_size - 260)
        for _ in range(target_merges):
            pairs = Counter()
            for seq in seqs:
                pairs.update(zip(seq, seq[1:]))
            if not pairs:
                break
            (a, b), freq = pairs.most_common(1)[0]
            if freq < min_freq:
                break
            new_id = 260 + len(tok.merges)
            tok.merges.append((a, b))
            seqs = [_apply_merge(s, (a, b), new_id) for s in seqs]
        tok._rebuild()
        return tok

    def encode(self, text: str) -> List[int]:
        seq = [b + 4 for b in text.encode("utf-8")]
        while len(seq) > 1:
            best, best_rank = None, None
            for pair in zip(seq, seq[1:]):
                r = self._merge_rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            seq = _apply_merge(seq, best, self._merged_id[best])
        return seq

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self._tok_bytes(i) for i in ids).decode(
            "utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return 260 + len(self.merges)

    def id_to_bytes(self, tid: int):
        """Raw bytes of one id (None = special) for the byte-level DFA."""
        return self._bytes.get(tid)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"type": "bpe", "merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            data = json.load(f)
        return cls(merges=[tuple(m) for m in data["merges"]])


def _apply_merge(seq: List[int], pair: Tuple[int, int], new_id: int) -> List[int]:
    out, i = [], 0
    while i < len(seq):
        if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


def load_tokenizer(path: Optional[str]) -> TokenizerBase:
    """Auto-detect: HF dir/file -> HFTokenizer; saved BPE json -> BPETokenizer;
    None -> ByteTokenizer."""
    if path is None:
        return ByteTokenizer()
    if os.path.isfile(path) and path.endswith(".json"):
        try:
            with open(path) as f:
                head = json.load(f)
            if isinstance(head, dict) and head.get("type") == "bpe":
                return BPETokenizer.load(path)
            if isinstance(head, dict) and head.get("type") == "byte":
                return ByteTokenizer()
        except (json.JSONDecodeError, UnicodeDecodeError):
            pass
    return HFTokenizer(path)
