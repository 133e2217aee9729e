"""GBNF grammar-constrained sampling — the port's own copy of
ggml_tpu/grammar.py, the llama.cpp grammars analog (grammars/*.gbnf,
llama-cli --grammar).

`parse_gbnf` compiles the GBNF text into rules of alternates (sequences
of char-sets and rule references; groups and the * + ? repetitions are
rewritten into synthesized rules, exactly llama.cpp's construction).
`GrammarState` simulates the pushdown automaton over code points: a set
of stacks of pending elements, advanced one character at a time — a
token is admissible iff every character of its text advances at least
one stack.  `GrammarSampler` walks logits in descending order and takes
the first token whose text the grammar accepts (EOS is admissible only
when some stack has fully emptied).

Host-side by design: grammar masking is inherently sequential/stateful,
so it rides the eager host loop of models.common.generate (python -m
ggml_tpu_torch.cli.generate --grammar); it is never captured in a decode
graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


# -- grammar elements ---------------------------------------------------------
# an alternate is a tuple of elements; an element is
#   ("char", ((lo, hi), ...), negated) — a code-point set
#   ("ref", rule_name)


@dataclass(frozen=True)
class _CharSet:
    ranges: tuple  # ((lo, hi), ...)
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.rules: dict[str, list[tuple]] = {}
        self._anon = 0

    # -- lexing helpers --
    def _ws(self):
        while self.i < len(self.text):
            c = self.text[self.i]
            if c == "#":  # comment to end of line
                while self.i < len(self.text) and self.text[self.i] != "\n":
                    self.i += 1
            elif c in " \t\r\n":
                self.i += 1
            else:
                break

    def _ws_inline(self):
        while self.i < len(self.text) and self.text[self.i] in " \t":
            self.i += 1
        if self.i < len(self.text) and self.text[self.i] == "#":
            while self.i < len(self.text) and self.text[self.i] != "\n":
                self.i += 1

    def _name(self) -> str:
        j = self.i
        while j < len(self.text) and (self.text[j].isalnum() or self.text[j] in "-_"):
            j += 1
        if j == self.i:
            raise ValueError(f"expected rule name at {self.i}: {self.text[self.i:self.i+20]!r}")
        name, self.i = self.text[self.i:j], j
        return name

    def _escape(self) -> str:
        c = self.text[self.i]
        self.i += 1
        if c != "\\":
            return c
        e = self.text[self.i]
        self.i += 1
        table = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\",
                 "[": "[", "]": "]", "'": "'"}
        if e in table:
            return table[e]
        if e in ("x", "u", "U"):
            n = {"x": 2, "u": 4, "U": 8}[e]
            cp = int(self.text[self.i:self.i + n], 16)
            self.i += n
            return chr(cp)
        raise ValueError(f"unknown escape \\{e}")

    # -- grammar --
    def parse(self):
        self._ws()
        while self.i < len(self.text):
            name = self._name()
            self._ws()
            if self.text[self.i:self.i + 3] != "::=":
                raise ValueError(f"expected ::= after {name}")
            self.i += 3
            self._ws()
            self.rules[name] = self._alternates(name)
            self._ws()
        if "root" not in self.rules:
            raise ValueError("grammar has no root rule")
        return self.rules

    def _alternates(self, base: str) -> list[tuple]:
        alts = [self._sequence(base)]
        while True:
            self._ws()
            if self.i < len(self.text) and self.text[self.i] == "|":
                self.i += 1
                self._ws()
                alts.append(self._sequence(base))
            else:
                break
        return alts

    def _sequence(self, base: str) -> tuple:
        out = []
        while self.i < len(self.text):
            self._ws_inline()
            if self.i >= len(self.text):
                break
            c = self.text[self.i]
            if c in "|)\n":
                break
            elem = self._element(base)
            # repetition suffixes
            while self.i < len(self.text) and self.text[self.i] in "*+?":
                op = self.text[self.i]
                self.i += 1
                elem = self._repeat(base, elem, op)
            out.append(elem)
        return tuple(out)

    def _anon_rule(self, base: str, alts: list[tuple]) -> tuple:
        self._anon += 1
        name = f"{base}${self._anon}"
        self.rules[name] = alts
        return ("ref", name)

    def _repeat(self, base: str, elem, op: str):
        if op == "?":
            return self._anon_rule(base, [(elem,), ()])
        self._anon += 1
        name = f"{base}${self._anon}"
        if op == "*":
            self.rules[name] = [(elem, ("ref", name)), ()]
        else:  # +
            self.rules[name] = [(elem, ("ref", name)), (elem,)]
        return ("ref", name)

    def _element(self, base: str):
        c = self.text[self.i]
        if c == '"':
            self.i += 1
            chars = []
            while self.text[self.i] != '"':
                chars.append(self._escape())
            self.i += 1
            if not chars:
                return self._anon_rule(base, [()])
            elems = tuple(("char", _CharSet(((ord(ch), ord(ch)),)))
                          for ch in chars)
            if len(elems) == 1:
                return elems[0]
            return self._anon_rule(base, [elems])
        if c == "[":
            self.i += 1
            negated = False
            if self.text[self.i] == "^":
                negated = True
                self.i += 1
            ranges = []
            while self.text[self.i] != "]":
                lo = self._escape()
                if self.text[self.i] == "-" and self.text[self.i + 1] != "]":
                    self.i += 1
                    hi = self._escape()
                else:
                    hi = lo
                ranges.append((ord(lo), ord(hi)))
            self.i += 1
            return ("char", _CharSet(tuple(ranges), negated))
        if c == "(":
            self.i += 1
            self._ws()
            alts = self._alternates(base)
            self._ws()
            if self.text[self.i] != ")":
                raise ValueError("unbalanced (")
            self.i += 1
            return self._anon_rule(base, alts)
        return ("ref", self._name())


def parse_gbnf(text: str) -> dict[str, list[tuple]]:
    return _Parser(text).parse()


class GrammarState:
    """Pushdown-automaton simulation: a set of stacks, each a tuple of
    pending elements (top last).  Stacks are kept in char-normal form —
    the top of every stack is a ("char", ...) element; an EMPTY stack in
    the set means the grammar can terminate here."""

    def __init__(self, rules: dict[str, list[tuple]], stacks=None):
        self.rules = rules
        if stacks is None:
            stacks = set()
            for alt in rules["root"]:
                stacks |= self._norm(tuple(reversed(alt)))
            self.stacks = frozenset(stacks)
        else:
            self.stacks = stacks

    def _norm(self, stack: tuple) -> set:
        """Expand rule refs until the top is a char element (or empty)."""
        if not stack or stack[-1][0] == "char":
            return {stack}
        out = set()
        top = stack[-1]
        rest = stack[:-1]
        for alt in self.rules[top[1]]:
            out |= self._norm(rest + tuple(reversed(alt)))
        return out

    def advance(self, ch: str) -> "GrammarState | None":
        """Consume one character; None if no stack accepts it."""
        cp = ord(ch)
        nxt = set()
        for stack in self.stacks:
            if stack and stack[-1][1].matches(cp):
                nxt |= self._norm(stack[:-1])
        if not nxt:
            return None
        return GrammarState(self.rules, frozenset(nxt))

    def accepts_text(self, text: str) -> "GrammarState | None":
        st = self
        for ch in text:
            st = st.advance(ch)
            if st is None:
                return None
        return st

    @property
    def can_end(self) -> bool:
        return any(not s for s in self.stacks)


class GrammarSampler:
    """Grammar-constrained sampler for the host-driven generate loop:
    walks logits in descending order, admits the first token whose text
    the grammar accepts (greedy) or masks the inadmissible ones before
    the categorical draw.  eos_id is admissible only at a completion
    point (matching llama_grammar_accept's end-of-grammar handling)."""

    def __init__(self, gbnf: str, tok, eos_id: int = -1, max_scan: int = 512):
        self.rules = parse_gbnf(gbnf)
        self.tok = tok
        self.eos_id = eos_id
        self.max_scan = max_scan  # candidates examined per step
        self.state = GrammarState(self.rules)
        self._text_cache: dict[int, str] = {}

    def reset(self):
        self.state = GrammarState(self.rules)

    def _token_text(self, tid: int) -> str:
        if tid not in self._text_cache:
            self._text_cache[tid] = self.tok.decode([tid])
        return self._text_cache[tid]

    def __call__(self, logits, key=None):
        """(1, V) logits tensor -> ((1,) long token on the logits' device,
        key), greedy over the admissible tokens: the row is copied to the
        host in f32 and scanned in the order of numpy's argsort, as the JAX
        sampler scans it."""
        lg = logits.detach().float().reshape(-1).cpu().numpy()
        order = np.argsort(lg)[::-1][: self.max_scan]
        pick = lambda tid: (torch.tensor([tid], dtype=torch.long, device=logits.device), key)
        for tid in order:
            tid = int(tid)
            if tid == self.eos_id:
                if self.state.can_end:
                    return pick(tid)
                continue
            nxt = self.state.accepts_text(self._token_text(tid))
            if nxt is not None:
                self.state = nxt
                return pick(tid)
        if self.state.can_end and self.eos_id >= 0:
            return pick(self.eos_id)
        raise ValueError("no admissible token under the grammar "
                         f"(scanned top {self.max_scan})")
