"""Structured outputs: grammar-constrained decoding (guided generation),
copied from deeppowers_tpu/serving/structured.py (host-only: numpy and the
standard library).

Covers the OpenAI `response_format` surface (json_object / json_schema) plus
`guided_regex` / `guided_choice` extensions. The reference has no equivalent
subsystem; this is the design for the capability its serving API
family implies (reference: src/api/http/rest_handler.cpp request schema).

Design — the automaton runs ON DEVICE so constrained decoding composes with
multi-step dispatch (no host round-trip per token):

1. A regex (or JSON schema lowered to a regex) compiles to a BYTE-level DFA
   (Thompson NFA -> subset construction) over a *compressed alphabet* —
   byte equivalence classes, so the transition table is (S, C) with C small.
   Character classes are held as codepoint intervals and lowered to UTF-8
   byte-range sequences (the utf8-ranges construction: split at encoded-
   length and surrogate boundaries, then emit per-byte range chains), so
   Unicode-wide classes like [^"] never materialize codepoints.
2. The tokenizer's vocabulary is walked through the DFA *vectorized over the
   vocab* (numpy) — over each token's raw BYTES: for each DFA state s,
   token t is allowed iff its bytes keep the DFA in live states, and
   `next_state[s, t]` is where it lands. Because the DFA is over bytes,
   tokens that are partial UTF-8 sequences (byte-level BPE vocabs) are
   first-class: a multi-byte character can be assembled across several
   tokens, with the DFA parked mid-character between them. Dead states
   (accept unreachable) are pruned first so the mask can never paint
   generation into a corner.
3. The engine stacks all registered guides' (allow, next_state) rows into two
   device tensors (runtime/engine.py `_register_guide`); the decode step
   masks logits with `allow[state]` and advances `state =
   next_state[state, token]`, a (B, V) gather per step with no host
   synchronization, so it is captured in the decode graphs
   (runtime/graphs.py) and composes with multi-step dispatch and
   speculative windows.
"""

from __future__ import annotations

import json
import weakref
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

_MAX_CP = 0x10FFFF
_SURR_LO, _SURR_HI = 0xD800, 0xDFFF

# ---------------------------------------------------------------------------
# Regex AST + parser (supported subset: literals, escapes, classes, ., | ,
# * + ? {m} {m,n} {m,}, groups (…) / (?:…))
# ---------------------------------------------------------------------------


def _merge_ranges(ranges) -> Tuple[Tuple[int, int], ...]:
    """Sort + coalesce codepoint intervals."""
    rs = sorted((lo, hi) for lo, hi in ranges if lo <= hi)
    out: List[List[int]] = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return tuple((lo, hi) for lo, hi in out)


@dataclass(frozen=True)
class _CharSet:
    """A set of codepoints as disjoint intervals, possibly negated
    (negated => complement over all Unicode scalar values)."""

    ranges: Tuple[Tuple[int, int], ...]
    negated: bool = False

    @classmethod
    def of(cls, chars: str, negated: bool = False) -> "_CharSet":
        return cls(_merge_ranges((ord(c), ord(c)) for c in chars), negated)

    def resolve(self) -> Tuple[Tuple[int, int], ...]:
        """Concrete intervals: apply negation over [0, 0x10FFFF] and carve
        out the surrogate block — the carve-out also guarantees no interval
        crosses the D800-DFFF gap, which the UTF-8 lowering relies on."""
        if not self.negated:
            src = self.ranges
        else:
            src = []
            prev = 0
            for lo, hi in self.ranges:
                if lo > prev:
                    src.append((prev, lo - 1))
                prev = max(prev, hi + 1)
            if prev <= _MAX_CP:
                src.append((prev, _MAX_CP))
        out = []
        for lo, hi in src:
            hi = min(hi, _MAX_CP)
            if hi < lo:
                continue
            if lo <= _SURR_HI and hi >= _SURR_LO:    # overlaps surrogates
                if lo < _SURR_LO:
                    out.append((lo, _SURR_LO - 1))
                if hi > _SURR_HI:
                    out.append((_SURR_HI + 1, hi))
            else:
                out.append((lo, hi))
        return tuple(out)


@dataclass
class _Node:
    kind: str                      # lit | alt | cat | star | plus | opt | rep
    cs: Optional[_CharSet] = None  # for lit
    kids: List["_Node"] = field(default_factory=list)
    lo: int = 0                    # for rep
    hi: Optional[int] = None       # None = unbounded


_WORD = ("abcdefghijklmnopqrstuvwxyz"
         "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_ESCAPES = {
    "d": _CharSet.of("0123456789"),
    "w": _CharSet.of(_WORD),
    "s": _CharSet.of(" \t\n\r\f\v"),
    "D": _CharSet.of("0123456789", negated=True),
    "W": _CharSet.of(_WORD, negated=True),
    "S": _CharSet.of(" \t\n\r\f\v", negated=True),
    "n": _CharSet.of("\n"),
    "t": _CharSet.of("\t"),
    "r": _CharSet.of("\r"),
    "f": _CharSet.of("\f"),
    "v": _CharSet.of("\v"),
    "0": _CharSet.of("\0"),
}


class RegexError(ValueError):
    pass


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def parse(self) -> _Node:
        node = self._alt()
        if self.i != len(self.p):
            raise RegexError(f"unexpected '{self.peek()}' at {self.i}")
        return node

    def _alt(self) -> _Node:
        branches = [self._cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self._cat())
        if len(branches) == 1:
            return branches[0]
        return _Node("alt", kids=branches)

    def _cat(self) -> _Node:
        kids = []
        while self.peek() not in ("", "|", ")"):
            kids.append(self._repeat())
        if len(kids) == 1:
            return kids[0]
        return _Node("cat", kids=kids)

    def _repeat(self) -> _Node:
        atom = self._atom()
        c = self.peek()
        if c == "*":
            self.take()
            return _Node("star", kids=[atom])
        if c == "+":
            self.take()
            return _Node("plus", kids=[atom])
        if c == "?":
            self.take()
            return _Node("opt", kids=[atom])
        if c == "{":
            save = self.i
            self.take()
            spec = ""
            while self.peek() not in ("", "}"):
                spec += self.take()
            if self.peek() != "}":
                raise RegexError("unterminated {…}")
            self.take()
            parts = spec.split(",")
            try:
                if len(parts) == 1:
                    lo = hi = int(parts[0])
                elif len(parts) == 2:
                    lo = int(parts[0]) if parts[0] else 0
                    hi = int(parts[1]) if parts[1] else None
                else:
                    raise ValueError
            except ValueError:
                # not a counted repeat (e.g. a literal '{' in a JSON regex) —
                # rewind and treat '{' as a literal
                self.i = save
                return atom
            if hi is not None and hi < lo:
                raise RegexError(f"bad repeat bounds {{{spec}}}")
            return _Node("rep", kids=[atom], lo=lo, hi=hi)
        return atom

    def _atom(self) -> _Node:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                if self.take() != ":":
                    raise RegexError("only (?:…) groups supported")
            inner = self._alt()
            if self.take() != ")":
                raise RegexError("unterminated group")
            return inner
        if c == "[":
            return _Node("lit", cs=self._char_class())
        if c == ".":
            return _Node("lit", cs=_CharSet.of("\n", negated=True))
        if c == "\\":
            return _Node("lit", cs=self._escape())
        if c in ")|*+?":
            raise RegexError(f"unexpected '{c}' at {self.i - 1}")
        return _Node("lit", cs=_CharSet.of(c))

    def _escape(self) -> _CharSet:
        e = self.take()
        if e == "":
            raise RegexError("dangling backslash")
        if e in _ESCAPES:
            return _ESCAPES[e]
        if e == "x":
            hexpair = self.take() + self.take()
            return _CharSet.of(chr(int(hexpair, 16)))
        if e == "u":
            quad = "".join(self.take() for _ in range(4))
            return _CharSet.of(chr(int(quad, 16)))
        return _CharSet.of(e)      # \. \\ \[ \{ etc.

    def _char_class(self) -> _CharSet:
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise RegexError("unterminated char class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            self.take()
            if c == "\\":
                es = self._escape()
                if es.negated:
                    raise RegexError("negated escape inside class")
                if len(es.ranges) != 1 or es.ranges[0][0] != es.ranges[0][1]:
                    ranges.extend(es.ranges)     # \d \w \s: never a range
                    continue
                lo_cp = es.ranges[0][0]          # \xNN / \uNNNN / \n …
            else:
                lo_cp = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()                      # '-'
                hi_c = self.take()
                if hi_c == "\\":
                    hi_set = self._escape()
                    if len(hi_set.ranges) != 1 or \
                            hi_set.ranges[0][0] != hi_set.ranges[0][1]:
                        raise RegexError("bad range end")
                    hi_cp = hi_set.ranges[0][0]
                else:
                    hi_cp = ord(hi_c)
                if hi_cp < lo_cp:
                    raise RegexError(f"bad range {chr(lo_cp)}-{chr(hi_cp)}")
                ranges.append((lo_cp, hi_cp))
            else:
                ranges.append((lo_cp, lo_cp))
        return _CharSet(_merge_ranges(ranges), negated=negated)


# ---------------------------------------------------------------------------
# UTF-8 lowering: codepoint intervals -> byte-range sequences
# ---------------------------------------------------------------------------


def _encode_cp(cp: int) -> List[int]:
    return list(chr(cp).encode("utf-8"))


def _split_by_len(lo: int, hi: int):
    """Split a codepoint interval at UTF-8 encoded-length boundaries."""
    for b in (0x80, 0x800, 0x10000):
        if lo < b <= hi:
            yield from _split_by_len(lo, b - 1)
            yield from _split_by_len(b, hi)
            return
    yield (lo, hi)


def _seq_ranges(lo_b: List[int], hi_b: List[int]) -> List[List[Tuple[int, int]]]:
    """Byte-range sequences covering all equal-length UTF-8 encodings between
    lo_b and hi_b (inclusive). Continuation bytes span [0x80, 0xBF] freely
    within a same-length block (callers split at length AND surrogate
    boundaries, so every in-range encoding is valid)."""
    n = len(lo_b)
    if n == 1:
        return [[(lo_b[0], hi_b[0])]]
    if lo_b[0] == hi_b[0]:
        return [[(lo_b[0], lo_b[0])] + t
                for t in _seq_ranges(lo_b[1:], hi_b[1:])]
    out: List[List[Tuple[int, int]]] = []
    full_lo = all(b == 0x80 for b in lo_b[1:])
    full_hi = all(b == 0xBF for b in hi_b[1:])
    start, end = lo_b[0], hi_b[0]
    if not full_lo:
        out += [[(lo_b[0], lo_b[0])] + t
                for t in _seq_ranges(lo_b[1:], [0xBF] * (n - 1))]
        start += 1
    mid_end = end if full_hi else end - 1
    if start <= mid_end:
        out.append([(start, mid_end)] + [(0x80, 0xBF)] * (n - 1))
    if not full_hi:
        out += [[(hi_b[0], hi_b[0])] + t
                for t in _seq_ranges([0x80] * (n - 1), hi_b[1:])]
    return out


def _utf8_byte_seqs(cs: _CharSet) -> List[List[Tuple[int, int]]]:
    out: List[List[Tuple[int, int]]] = []
    for lo, hi in cs.resolve():
        for l2, h2 in _split_by_len(lo, hi):
            out += _seq_ranges(_encode_cp(l2), _encode_cp(h2))
    return out


# ---------------------------------------------------------------------------
# Byte alphabet compression + NFA + subset construction
# ---------------------------------------------------------------------------


def _collect_lits(node: _Node, out: List[_Node]) -> None:
    if node.kind == "lit":
        out.append(node)
    for k in node.kids:
        _collect_lits(k, out)


class _Alphabet:
    """Partition of the 256 byte values into equivalence classes w.r.t. every
    byte range the lowered pattern uses."""

    def __init__(self, ranges: Sequence[Tuple[int, int]]):
        uniq = sorted(set(ranges))
        sig_of: Dict[Tuple[bool, ...], int] = {}
        self.byte_class = np.zeros((256,), dtype=np.int32)
        for b in range(256):
            sig = tuple(lo <= b <= hi for lo, hi in uniq)
            if sig not in sig_of:
                sig_of[sig] = len(sig_of)
            self.byte_class[b] = sig_of[sig]
        self.n_classes = len(sig_of)

    def classes_of_range(self, lo: int, hi: int) -> FrozenSet[int]:
        return frozenset(int(c) for c in
                         np.unique(self.byte_class[lo:hi + 1]))

    def class_of_byte(self, b: int) -> int:
        return int(self.byte_class[b])

    def class_of_char(self, ch: str) -> int:
        """Compat helper for single-byte (ASCII) chars; multi-byte chars need
        a byte walk — use DFA.matches / DFA.step_str."""
        bs = ch.encode("utf-8")
        if len(bs) != 1:
            raise ValueError(
                "class_of_char is single-byte only on the byte-level DFA; "
                "walk DFA.step_str instead")
        return int(self.byte_class[bs[0]])


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _build_nfa(node: _Node, nfa: _NFA, alpha: _Alphabet,
               seqs_of: Dict[int, List[List[Tuple[int, int]]]]
               ) -> Tuple[int, int]:
    """Returns (start, end) NFA fragment states."""
    if node.kind == "lit":
        s, e = nfa.new(), nfa.new()
        for seq in seqs_of[id(node)]:
            cur = s
            for j, (blo, bhi) in enumerate(seq):
                nxt = e if j == len(seq) - 1 else nfa.new()
                nfa.edges[cur].append((alpha.classes_of_range(blo, bhi), nxt))
                cur = nxt
        return s, e
    if node.kind == "cat":
        if not node.kids:
            s = nfa.new()
            return s, s
        s, e = _build_nfa(node.kids[0], nfa, alpha, seqs_of)
        for k in node.kids[1:]:
            s2, e2 = _build_nfa(k, nfa, alpha, seqs_of)
            nfa.eps[e].append(s2)
            e = e2
        return s, e
    if node.kind == "alt":
        s, e = nfa.new(), nfa.new()
        for k in node.kids:
            ks, ke = _build_nfa(k, nfa, alpha, seqs_of)
            nfa.eps[s].append(ks)
            nfa.eps[ke].append(e)
        return s, e
    if node.kind == "star":
        s, e = nfa.new(), nfa.new()
        ks, ke = _build_nfa(node.kids[0], nfa, alpha, seqs_of)
        nfa.eps[s] += [ks, e]
        nfa.eps[ke] += [ks, e]
        return s, e
    if node.kind == "plus":
        ks, ke = _build_nfa(node.kids[0], nfa, alpha, seqs_of)
        nfa.eps[ke].append(ks)
        e = nfa.new()
        nfa.eps[ke].append(e)
        return ks, e
    if node.kind == "opt":
        s, e = nfa.new(), nfa.new()
        ks, ke = _build_nfa(node.kids[0], nfa, alpha, seqs_of)
        nfa.eps[s] += [ks, e]
        nfa.eps[ke].append(e)
        return s, e
    if node.kind == "rep":
        # expand {lo,hi} by duplication; {lo,} = lo copies + star
        s = nfa.new()
        e = s
        for _ in range(node.lo):
            ks, ke = _build_nfa(node.kids[0], nfa, alpha, seqs_of)
            nfa.eps[e].append(ks)
            e = ke
        if node.hi is None:
            ks, ke = _build_nfa(_Node("star", kids=node.kids), nfa, alpha,
                                seqs_of)
            nfa.eps[e].append(ks)
            e = ke
        else:
            for _ in range(node.hi - node.lo):
                ks, ke = _build_nfa(_Node("opt", kids=node.kids), nfa, alpha,
                                    seqs_of)
                nfa.eps[e].append(ks)
                e = ke
        return s, e
    raise RegexError(f"unknown node {node.kind}")


MAX_DFA_STATES = 50_000


@dataclass
class DFA:
    """Byte-level DFA over a compressed byte alphabet. trans: (S, C) int32
    with -1 = reject; state 0 is initial; only live (co-accessible) states
    remain."""

    trans: np.ndarray
    accept: np.ndarray           # (S,) bool
    alphabet: _Alphabet

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def step_bytes(self, state: int, data: bytes) -> int:
        """Walk raw bytes from `state`; -1 = dead."""
        cls = self.alphabet.byte_class
        for b in data:
            if state < 0:
                return -1
            state = int(self.trans[state, cls[b]])
        return state

    def step_str(self, state: int, s: str) -> int:
        return self.step_bytes(state, s.encode("utf-8"))

    def matches(self, s: str) -> bool:
        st = self.step_str(0, s)
        return bool(st >= 0 and self.accept[st])


def compile_regex(pattern: str) -> DFA:
    """Compile a regex (fullmatch semantics) to a pruned byte-class DFA."""
    ast = _Parser(pattern).parse()
    lits: List[_Node] = []
    _collect_lits(ast, lits)
    seqs_of = {id(n): _utf8_byte_seqs(n.cs) for n in lits}
    all_ranges = [r for seqs in seqs_of.values() for seq in seqs for r in seq]
    alpha = _Alphabet(all_ranges)
    nfa = _NFA()
    start, end = _build_nfa(ast, nfa, alpha, seqs_of)

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    init = closure(frozenset([start]))
    index: Dict[FrozenSet[int], int] = {init: 0}
    order = [init]
    rows: List[List[int]] = []
    accepts: List[bool] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        row = [-1] * alpha.n_classes
        for c in range(alpha.n_classes):
            nxt = set()
            for s in cur:
                for classes, t in nfa.edges[s]:
                    if c in classes:
                        nxt.add(t)
            if nxt:
                key = closure(frozenset(nxt))
                if key not in index:
                    if len(index) >= MAX_DFA_STATES:
                        raise RegexError(
                            f"DFA exceeds {MAX_DFA_STATES} states — simplify "
                            "the pattern / schema (lower nesting depth)")
                    index[key] = len(order)
                    order.append(key)
                row[c] = index[key]
        rows.append(row)
        accepts.append(end in cur)

    trans = np.asarray(rows, dtype=np.int32)
    accept = np.asarray(accepts, dtype=bool)

    # prune dead states (accept unreachable): reverse BFS from accepts
    n = trans.shape[0]
    live = accept.copy()
    changed = True
    while changed:
        changed = False
        reaches = live[np.where(trans >= 0, trans, 0)] & (trans >= 0)
        new_live = live | reaches.any(axis=1)
        if (new_live != live).any():
            live = new_live
            changed = True
    if not live[0]:
        raise RegexError("pattern matches nothing")
    remap = -np.ones((n,), dtype=np.int32)
    remap[live] = np.arange(int(live.sum()), dtype=np.int32)
    trans = np.where((trans >= 0) & live[np.where(trans >= 0, trans, 0)],
                     remap[np.where(trans >= 0, trans, 0)], -1)
    trans = trans[live].astype(np.int32)
    accept = accept[live]
    trans, accept = _minimize(trans, accept)
    return DFA(trans=trans, accept=accept, alphabet=alpha)


def _minimize(trans: np.ndarray, accept: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Moore partition refinement. Nested schemas duplicate STRING/NUMBER
    sub-automata at every level — minimization collapses them (measured 30x+
    on the generic-JSON grammar), which bounds the (S, V) token-mask tables
    the engine uploads to HBM."""
    n = trans.shape[0]
    labels = accept.astype(np.int64)
    k = int(labels.max()) + 1
    # dead (-1) entries map to a sentinel class that never merges with a state
    while True:
        tgt = np.where(trans >= 0, labels[np.where(trans >= 0, trans, 0)], -1)
        sig = np.concatenate([labels[:, None], tgt], axis=1)
        _, labels = np.unique(sig, axis=0, return_inverse=True)
        new_k = int(labels.max()) + 1
        if new_k == k or new_k == n:   # refinement is monotone: stable
            break
        k = new_k
    # one representative per class; class of state 0 becomes new state 0
    k = int(labels.max()) + 1
    if k == n:
        return trans, accept
    order = np.zeros((k,), dtype=np.int64)
    seen = np.zeros((k,), dtype=bool)
    perm = np.full((k,), -1, dtype=np.int64)   # class -> new id
    nxt = 1
    perm[labels[0]] = 0
    order[0] = 0
    seen[labels[0]] = True
    for s in range(n):
        c = labels[s]
        if not seen[c]:
            seen[c] = True
            perm[c] = nxt
            order[nxt] = s
            nxt += 1
    reps = order[:k]
    new_trans = trans[reps]
    new_trans = np.where(new_trans >= 0,
                         perm[labels[np.where(new_trans >= 0, new_trans, 0)]],
                         -1).astype(np.int32)
    new_accept = accept[reps]
    return new_trans, new_accept


# ---------------------------------------------------------------------------
# Tokenizer vocabulary -> per-state token masks
# ---------------------------------------------------------------------------


def token_bytes(tokenizer) -> List[Optional[bytes]]:
    """Raw byte string of every vocab id; None = never allowed (control /
    special tokens). Partial-UTF-8 byte tokens are returned as their raw
    bytes — the byte-level DFA handles them natively.

    Accepts the serving TokenizerBase wrappers (tokenizer.py), raw
    `tokenizers.Tokenizer`, and transformers tokenizers."""
    inner = getattr(tokenizer, "_tok", None)
    if inner is not None and (hasattr(inner, "convert_ids_to_tokens")
                              or hasattr(inner, "id_to_token")):
        tokenizer = inner
    if hasattr(tokenizer, "convert_ids_to_tokens"):      # transformers
        size = len(tokenizer)
        pieces = tokenizer.convert_ids_to_tokens(list(range(size)))
        special = set(getattr(tokenizer, "all_special_ids", []) or [])
        return _piece_bytes(pieces, special)
    if hasattr(tokenizer, "id_to_token"):                # tokenizers.Tokenizer
        size = tokenizer.get_vocab_size()
        pieces = [tokenizer.id_to_token(i) for i in range(size)]
        return _piece_bytes(pieces, set())
    if hasattr(tokenizer, "id_to_bytes"):    # internal byte-aware tokenizers
        return [tokenizer.id_to_bytes(tid)
                for tid in range(tokenizer.vocab_size)]
    # last resort: per-id decode; ids that don't decode standalone are banned
    out: List[Optional[bytes]] = []
    for tid in range(tokenizer.vocab_size):
        try:
            s = tokenizer.decode([tid])
        except Exception:
            s = None
        out.append(s.encode("utf-8") if s and "�" not in s else None)
    return out


def token_strings(tokenizer) -> List[Optional[str]]:
    """Decoded string of every vocab id; None = not representable as a
    standalone string (partial UTF-8) or special. Kept for debugging/tests;
    guide construction uses token_bytes."""
    out: List[Optional[str]] = []
    for b in token_bytes(tokenizer):
        if b is None:
            out.append(None)
            continue
        try:
            out.append(b.decode("utf-8"))
        except UnicodeDecodeError:
            out.append(None)
    return out


def _gpt2_byte_decoder() -> Dict[str, int]:
    """Inverse of the GPT-2 byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _piece_bytes(pieces: Sequence[Optional[str]],
                 special: set) -> List[Optional[bytes]]:
    """Vocab *pieces* (Ġ-style byte-level BPE or ▁-style sentencepiece) ->
    raw token bytes."""
    byte_level = any(p is not None and ("Ġ" in p or "Ċ" in p)
                     for p in pieces[:4000])
    byte_decoder = _gpt2_byte_decoder() if byte_level else None
    out: List[Optional[bytes]] = []
    for tid, p in enumerate(pieces):
        if p is None or tid in special:
            out.append(None)
            continue
        if byte_decoder is not None:
            try:
                out.append(bytes(byte_decoder[ch] for ch in p))
            except KeyError:
                out.append(None)       # piece outside the byte table: special
            continue
        if p.startswith("<0x") and p.endswith(">") and len(p) == 6:
            out.append(bytes([int(p[3:5], 16)]))    # sentencepiece byte token
            continue
        if p.startswith("<") and p.endswith(">") and len(p) > 2:
            out.append(None)           # special-looking piece
            continue
        out.append(p.replace("▁", " ").encode("utf-8"))
    return out


@dataclass
class Guide:
    """Compiled token-level guide: per-DFA-state token masks + transitions.

    allow:       (S, V) bool — token permitted from state s
    next_state:  (S, V) int32 — landing state (0 where not allowed; the mask
                 guarantees those entries are never taken)
    eos_allowed: (S,) bool — EOS permitted (state accepts)
    """

    allow: np.ndarray
    next_state: np.ndarray
    eos_allowed: np.ndarray
    key: str                      # cache identity (pattern)

    @property
    def n_states(self) -> int:
        return self.allow.shape[0]


def build_guide(dfa: DFA, token_strs: Sequence, key: str = "") -> Guide:
    """Walk every vocab token through the byte DFA from every state,
    vectorized over the vocabulary (numpy). token_strs entries may be str,
    bytes, or None (banned)."""
    toks: List[Optional[bytes]] = [
        t.encode("utf-8") if isinstance(t, str) else t for t in token_strs]
    v = len(toks)
    max_len = max((len(t) for t in toks if t), default=1)
    tok_cls = np.full((v, max_len), -1, dtype=np.int32)
    valid = np.zeros((v,), dtype=bool)
    for tid, t in enumerate(toks):
        if not t:
            continue
        valid[tid] = True
        for j, b in enumerate(t):
            tok_cls[tid, j] = dfa.alphabet.byte_class[b]

    s_total = dfa.n_states
    # trans with a sink row so vectorized gathers stay in-bounds
    trans_ext = np.concatenate(
        [dfa.trans, -np.ones((1, dfa.trans.shape[1]), np.int32)], axis=0)
    allow = np.zeros((s_total, v), dtype=bool)
    next_state = np.zeros((s_total, v), dtype=np.int32)
    for s in range(s_total):
        cur = np.full((v,), s, dtype=np.int32)
        alive = valid.copy()
        for j in range(max_len):
            c = tok_cls[:, j]
            step = c >= 0
            nxt = trans_ext[np.where(cur >= 0, cur, s_total),
                            np.where(step, c, 0)]
            died = step & (nxt < 0)
            alive &= ~died
            cur = np.where(step & alive, nxt, cur)
        allow[s] = alive
        next_state[s] = np.where(alive, np.maximum(cur, 0), 0)
    return Guide(allow=allow, next_state=next_state,
                 eos_allowed=dfa.accept.copy(), key=key)


# ---------------------------------------------------------------------------
# JSON schema -> regex
# ---------------------------------------------------------------------------

# single optional space keeps the DFA small; the model may emit compact or
# lightly-spaced JSON, both parse
_WS = r"[ ]?"
_STRING_INNER = r'(?:[^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*'
_STRING = f'"{_STRING_INNER}"'
_INTEGER = r"-?(?:0|[1-9][0-9]*)"
_NUMBER = r"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_BOOLEAN = r"(?:true|false)"
_NULL = r"null"


def _escape_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in r"\^$.|?*+()[]{}":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def json_schema_to_regex(schema: Optional[dict], *, depth: int = 4) -> str:
    """Lower a JSON-schema subset to a regex: type string/number/integer/
    boolean/null/object/array, enum, const, properties(+required), items,
    minItems/maxItems, anyOf/oneOf. None / {} => any JSON value to `depth`
    levels of nesting."""
    if not schema:
        return _json_value_regex(depth)
    return _schema(schema, depth)


def _json_value_regex(depth: int) -> str:
    scalar = f"(?:{_STRING}|{_NUMBER}|{_BOOLEAN}|{_NULL})"
    v = scalar
    for _ in range(depth):
        arr = (rf"\[{_WS}\]|\[{_WS}{v}(?:{_WS},{_WS}{v})*{_WS}\]")
        kv = f"{_STRING}{_WS}:{_WS}{v}"
        obj = (rf"\{{{_WS}\}}|\{{{_WS}{kv}(?:{_WS},{_WS}{kv})*{_WS}\}}")
        v = f"(?:{scalar}|{arr}|{obj})"
    return v


def _schema(s: dict, depth: int) -> str:
    if "enum" in s:
        opts = "|".join(_escape_literal(json.dumps(v, ensure_ascii=False))
                        for v in s["enum"])
        return f"(?:{opts})"
    if "const" in s:
        return _escape_literal(json.dumps(s["const"], ensure_ascii=False))
    for comb in ("anyOf", "oneOf"):
        if comb in s:
            opts = "|".join(_schema(sub, depth) for sub in s[comb])
            return f"(?:{opts})"
    t = s.get("type")
    if isinstance(t, list):
        return "(?:" + "|".join(
            _schema({**s, "type": tt}, depth) for tt in t) + ")"
    if t == "string":
        if "pattern" in s:
            return f'"{s["pattern"]}"'
        lo = s.get("minLength")
        hi = s.get("maxLength")
        if lo is not None or hi is not None:
            one = r'(?:[^"\\\x00-\x1f]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})'
            return f'"{one}{{{lo or 0},{hi if hi is not None else ""}}}"'
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return _BOOLEAN
    if t == "null":
        return _NULL
    if t == "array":
        item = _schema(s.get("items") or {}, depth - 1) if depth > 0 \
            else _json_value_regex(0)
        lo = int(s.get("minItems", 0))
        hi = s.get("maxItems")
        if lo == 0:
            empty = rf"\[{_WS}\]"
            more = "*" if hi is None else f"{{0,{max(int(hi) - 1, 0)}}}"
            body = rf"\[{_WS}{item}(?:{_WS},{_WS}{item}){more}{_WS}\]"
            return f"(?:{empty}|{body})" if hi != 0 else empty
        more = f"{{{lo - 1},}}" if hi is None \
            else f"{{{lo - 1},{int(hi) - 1}}}"
        return rf"\[{_WS}{item}(?:{_WS},{_WS}{item}){more}{_WS}\]"
    if t == "object" or "properties" in s:
        return _object_regex(s, depth)
    # untyped: any value
    return _json_value_regex(max(depth, 0))


def _object_regex(s: dict, depth: int) -> str:
    props = s.get("properties") or {}
    required = set(s.get("required") or [])
    items = [
        (f'"{_escape_literal(k)}"{_WS}:{_WS}'
         + (_schema(sub, depth - 1) if depth > 0 else _json_value_regex(0)),
         k in required)
        for k, sub in props.items()
    ]
    if not items:
        return rf"\{{{_WS}\}}"

    # ordered-subsequence chain containing every required property:
    # f(i, first) = regex for properties i.. given whether one was already
    # emitted (first => no leading comma). Memoized, linear size.
    memo: Dict[Tuple[int, bool], Optional[str]] = {}

    def f(i: int, first: bool) -> Optional[str]:
        if i == len(items):
            return ""
        if (i, first) in memo:
            return memo[(i, first)]
        pat, req = items[i]
        opts = []
        take_rest = f(i + 1, False)
        if take_rest is not None:
            lead = "" if first else f"{_WS},{_WS}"
            opts.append(f"{lead}{pat}{take_rest}")
        if not req:
            skip = f(i + 1, first)
            if skip is not None:
                opts.append(skip)
        if not opts:
            memo[(i, first)] = None
            return None
        r = opts[0] if len(opts) == 1 else "(?:" + "|".join(opts) + ")"
        memo[(i, first)] = r
        return r

    body = f(0, True)
    if body is None:
        raise RegexError("unsatisfiable object schema")
    if body == "":
        return rf"\{{{_WS}\}}"
    if not required:
        return rf"(?:\{{{_WS}\}}|\{{{_WS}{body}{_WS}\}})"
    return rf"\{{{_WS}{body}{_WS}\}}"


# ---------------------------------------------------------------------------
# Public compile surface (cached per (pattern, tokenizer))
# ---------------------------------------------------------------------------

_GUIDE_CACHE: Dict[Tuple[str, int], Tuple[weakref.ref, Guide]] = {}
_GUIDE_CACHE_MAX = 64


def compile_guide(pattern: str, tokenizer) -> Guide:
    """Regex -> Guide for `tokenizer`'s vocab, cached. An entry keeps a
    weak reference to its tokenizer: JAX's cache keys on id(tokenizer)
    alone, so a tokenizer made where a freed one lived could be handed the
    freed one's guide."""
    key = (pattern, id(tokenizer))
    hit = _GUIDE_CACHE.get(key)
    if hit is not None and hit[0]() is tokenizer:
        return hit[1]
    dfa = compile_regex(pattern)
    g = build_guide(dfa, token_bytes(tokenizer), key=pattern)
    if len(_GUIDE_CACHE) >= _GUIDE_CACHE_MAX:
        _GUIDE_CACHE.pop(next(iter(_GUIDE_CACHE)))
    _GUIDE_CACHE[key] = (weakref.ref(tokenizer), g)
    return g


def guide_for_json(schema: Optional[dict], tokenizer, *,
                   depth: int = 4) -> Guide:
    return compile_guide(json_schema_to_regex(schema, depth=depth), tokenizer)


def guide_for_choice(options: Sequence[str], tokenizer) -> Guide:
    if not options:
        raise ValueError("guided_choice needs at least one option")
    pat = "(?:" + "|".join(_escape_literal(o) for o in options) + ")"
    return compile_guide(pat, tokenizer)
