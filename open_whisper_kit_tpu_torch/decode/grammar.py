# Source: open_whisper_kit_tpu/decode/grammar.py, copied as it stands (pure Python and numpy, no JAX).
"""GBNF grammar-constrained decoding.

Ports of the reference grammar engine:
* GBNF text -> rule elements (examples/grammar-parser.cpp semantics),
* the pushdown-stack matcher with UTF-8 partial-sequence handling
  (src/whisper.cpp:5498-5910): advance_stack / accept / reject_candidates,
* logit integration: rejected tokens get `grammar_penalty` subtracted
  (whisper_suppress_invalid_grammar, :5838-5880), applied only when the
  timestamp-force rule did not fire (:6365-6388).

Element encoding matches whisper_gretype (include/whisper.h:162-190):
END=0, ALT=1, RULE_REF=2, CHAR=3, CHAR_NOT=4, CHAR_RNG_UPPER=5, CHAR_ALT=6.
"""

from __future__ import annotations

import dataclasses

import numpy as np

END, ALT, RULE_REF, CHAR, CHAR_NOT, CHAR_RNG_UPPER, CHAR_ALT = range(7)

Element = tuple[int, int]          # (type, value)
Rule = list[Element]
Pos = tuple[int, int]              # (rule_id, element_index)


# ---------------------------------------------------------------------------
# GBNF parsing
# ---------------------------------------------------------------------------

class GBNFError(ValueError):
    pass


class _Parser:
    """GBNF text -> numbered rules (grammar-parser.cpp behavior: literals,
    char classes with ranges/negation, escapes, ( ) grouping, | alternates,
    * + ? repetition via synthesized rules, # comments)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, Rule] = {}

    # -- lexing helpers ---------------------------------------------------

    def _ws(self):
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in " \t\r\n":
                self.pos += 1
            elif c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                break

    def _name(self) -> str:
        start = self.pos
        while (self.pos < len(self.text)
               and (self.text[self.pos].isalnum() or self.text[self.pos] in "-_")):
            self.pos += 1
        if self.pos == start:
            raise GBNFError(f"expected name at {start}")
        return self.text[start:self.pos]

    def _char(self) -> int:
        c = self.text[self.pos]
        if c == "\\":
            self.pos += 1
            e = self.text[self.pos]
            self.pos += 1
            if e == "x":
                v = int(self.text[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if e == "u":
                v = int(self.text[self.pos:self.pos + 4], 16)
                self.pos += 4
                return v
            if e == "U":
                v = int(self.text[self.pos:self.pos + 8], 16)
                self.pos += 8
                return v
            return {"t": 9, "r": 13, "n": 10}.get(e, ord(e))
        self.pos += 1
        return ord(c)

    def _sym_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _gen_id(self, base: str) -> int:
        name = f"{base}_{len(self.symbol_ids)}"
        return self._sym_id(name)

    # -- grammar productions ---------------------------------------------

    def parse(self) -> tuple[list[Rule], dict[str, int]]:
        self._ws()
        while self.pos < len(self.text):
            self._rule()
            self._ws()
        n = len(self.symbol_ids)
        rules = [self.rules.get(i, [(END, 0)]) for i in range(n)]
        for i, r in enumerate(rules):
            if not r or r[-1][0] != END:
                rules[i] = r + [(END, 0)]
        return rules, dict(self.symbol_ids)

    def _rule(self):
        name = self._name()
        self._ws()
        if self.text[self.pos:self.pos + 3] != "::=":
            raise GBNFError(f"expected ::= after {name}")
        self.pos += 3
        self._ws()
        rule_id = self._sym_id(name)
        self.rules[rule_id] = self._alternates(name)

    def _alternates(self, base: str) -> Rule:
        out: Rule = []
        out.extend(self._sequence(base))
        self._ws_inline()
        while self.pos < len(self.text) and self.text[self.pos] == "|":
            self.pos += 1
            self._ws()
            out.append((ALT, 0))
            out.extend(self._sequence(base))
            self._ws_inline()
        out.append((END, 0))
        return out

    def _ws_inline(self):
        # whitespace that may include newlines followed by | continuation
        save = self.pos
        self._ws()
        if self.pos < len(self.text) and self.text[self.pos] == "|":
            return
        # a newline (not followed by |) ends the rule
        if "\n" in self.text[save:self.pos]:
            self.pos = save
            while (self.pos < len(self.text)
                   and self.text[self.pos] in " \t"):
                self.pos += 1

    def _sequence(self, base: str) -> Rule:
        out: Rule = []
        last_start = 0
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == '"':
                last_start = len(out)
                self.pos += 1
                while self.text[self.pos] != '"':
                    out.append((CHAR, self._char()))
                self.pos += 1
            elif c == "[":
                last_start = len(out)
                self.pos += 1
                neg = self.text[self.pos] == "^"
                if neg:
                    self.pos += 1
                first = True
                while self.text[self.pos] != "]":
                    v = self._char()
                    etype = (CHAR_NOT if neg else CHAR) if first else CHAR_ALT
                    out.append((etype, v))
                    first = False
                    if (self.text[self.pos] == "-"
                            and self.text[self.pos + 1] != "]"):
                        self.pos += 1
                        out.append((CHAR_RNG_UPPER, self._char()))
                self.pos += 1
            elif c == "(":
                last_start = len(out)
                self.pos += 1
                self._ws()
                sub_id = self._gen_id(base)
                self.rules[sub_id] = self._alternates(base)
                self._ws()
                if self.text[self.pos] != ")":
                    raise GBNFError("expected )")
                self.pos += 1
                out.append((RULE_REF, sub_id))
            elif c.isalnum() or c in "-_":
                last_start = len(out)
                name = self._name()
                out.append((RULE_REF, self._sym_id(name)))
            elif c in "*+?":
                self.pos += 1
                piece = out[last_start:]
                del out[last_start:]
                sub_id = self._gen_id(base)
                if c == "*":
                    # S ::= piece S |
                    self.rules[sub_id] = piece + [(RULE_REF, sub_id), (ALT, 0), (END, 0)]
                elif c == "+":
                    # S ::= piece S | piece
                    self.rules[sub_id] = (piece + [(RULE_REF, sub_id), (ALT, 0)]
                                          + piece + [(END, 0)])
                else:
                    # S ::= piece |
                    self.rules[sub_id] = piece + [(ALT, 0), (END, 0)]
                out.append((RULE_REF, sub_id))
                last_start = len(out) - 1
            else:
                break
            # inline whitespace between sequence items
            while (self.pos < len(self.text)
                   and self.text[self.pos] in " \t"):
                self.pos += 1
            if self.pos < len(self.text) and self.text[self.pos] == "\n":
                nxt = self.pos
                while nxt < len(self.text) and self.text[nxt] in " \t\r\n":
                    nxt += 1
                # newline ends the sequence unless continued by | or )
                if nxt >= len(self.text) or self.text[nxt] != "|":
                    if nxt < len(self.text) and self.text[nxt] == ")":
                        self.pos = nxt
                        continue
                    break
        return out


def parse_gbnf(text: str, start: str = "root") -> tuple[list[Rule], int]:
    """-> (rules, start_rule_id); `start` names the entry rule (the
    reference exposes the same choice as whisper_full_params.i_start_rule,
    used e.g. by wchess with its 'move' rule)."""
    rules, symbols = _Parser(text).parse()
    if start not in symbols:
        raise GBNFError(f"grammar must define a '{start}' rule")
    return rules, symbols[start]


# ---------------------------------------------------------------------------
# UTF-8 decoding with partial-sequence carry (whisper.cpp:5498-5552)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PartialUtf8:
    value: int = 0
    n_remain: int = 0


def decode_utf8(data: bytes, partial: PartialUtf8) -> tuple[list[int], PartialUtf8]:
    lookup = [1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 2, 2, 3, 4]
    pos = 0
    code_points: list[int] = []
    value, n_remain = partial.value, partial.n_remain

    while pos < len(data) and n_remain > 0:
        b = data[pos]
        if (b >> 6) != 2:
            return [0], PartialUtf8(0, -1)
        value = (value << 6) + (b & 0x3F)
        pos += 1
        n_remain -= 1
    if partial.n_remain > 0 and n_remain == 0:
        code_points.append(value)

    while pos < len(data):
        first = data[pos]
        n_remain = lookup[first >> 4] - 1
        if n_remain < 0:
            return [0], PartialUtf8(0, n_remain)
        mask = (1 << (7 - n_remain)) - 1
        value = first & mask
        pos += 1
        while pos < len(data) and n_remain > 0:
            value = (value << 6) + (data[pos] & 0x3F)
            pos += 1
            n_remain -= 1
        if n_remain == 0:
            code_points.append(value)
    code_points.append(0)
    return code_points, PartialUtf8(value, n_remain)


# ---------------------------------------------------------------------------
# Pushdown matcher
# ---------------------------------------------------------------------------

class Grammar:
    """Grammar state: rules + set of pushdown stacks + partial utf8."""

    def __init__(self, rules: list[Rule], start_rule: int):
        self.rules = rules
        self.partial_utf8 = PartialUtf8()
        self.stacks: list[tuple[Pos, ...]] = []
        # initial stacks from each alternate of the start rule
        pos = 0
        rule = rules[start_rule]
        while True:
            stack: list[Pos] = []
            if not self._is_end(rule[pos]):
                stack.append((start_rule, pos))
            self._advance(tuple(stack), self.stacks)
            while not self._is_end(rule[pos]):
                pos += 1
            if rule[pos][0] == ALT:
                pos += 1
            else:
                break

    @classmethod
    def from_gbnf(cls, text: str, start: str = "root") -> "Grammar":
        rules, root = parse_gbnf(text, start)
        return cls(rules, root)

    def copy(self) -> "Grammar":
        g = object.__new__(Grammar)
        g.rules = self.rules
        g.partial_utf8 = self.partial_utf8
        g.stacks = list(self.stacks)
        return g

    # -- helpers ----------------------------------------------------------

    def _el(self, pos: Pos) -> Element:
        return self.rules[pos[0]][pos[1]]

    @staticmethod
    def _is_end(el: Element) -> bool:
        return el[0] in (END, ALT)

    def _match_char(self, pos: Pos, chr_: int) -> tuple[bool, Pos]:
        rule = self.rules[pos[0]]
        i = pos[1]
        el = rule[i]
        is_positive = el[0] == CHAR
        found = False
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                found = found or (rule[i][1] <= chr_ <= rule[i + 1][1])
                i += 2
            else:
                found = found or rule[i][1] == chr_
                i += 1
            if i >= len(rule) or rule[i][0] != CHAR_ALT:
                break
        return found == is_positive, (pos[0], i)

    def _match_partial(self, pos: Pos, partial: PartialUtf8) -> bool:
        rule = self.rules[pos[0]]
        i = pos[1]
        is_positive = rule[i][0] == CHAR
        value, n_remain = partial.value, partial.n_remain
        if n_remain < 0 or (n_remain == 1 and value < 2):
            return False
        low = value << (n_remain * 6)
        high = low | ((1 << (n_remain * 6)) - 1)
        if low == 0:
            if n_remain == 2:
                low = 1 << 11
            elif n_remain == 3:
                low = 1 << 16
        while True:
            if i + 1 < len(rule) and rule[i + 1][0] == CHAR_RNG_UPPER:
                if rule[i][1] <= high and low <= rule[i + 1][1]:
                    return is_positive
                i += 2
            else:
                if low <= rule[i][1] <= high:
                    return is_positive
                i += 1
            if i >= len(rule) or rule[i][0] != CHAR_ALT:
                break
        return not is_positive

    def _advance(self, stack: tuple[Pos, ...],
                 new_stacks: list[tuple[Pos, ...]]):
        """whisper_grammar_advance_stack (:5641-5696)."""
        if not stack:
            if () not in new_stacks:
                new_stacks.append(())
            return
        pos = stack[-1]
        el = self._el(pos)
        if el[0] == RULE_REF:
            rule_id = el[1]
            sub = self.rules[rule_id]
            subpos = 0
            while True:
                new_stack = list(stack[:-1])
                nxt = (pos[0], pos[1] + 1)
                if not self._is_end(self._el(nxt)):
                    new_stack.append(nxt)
                if not self._is_end(sub[subpos]):
                    new_stack.append((rule_id, subpos))
                self._advance(tuple(new_stack), new_stacks)
                while not self._is_end(sub[subpos]):
                    subpos += 1
                if sub[subpos][0] == ALT:
                    subpos += 1
                else:
                    break
        elif el[0] in (CHAR, CHAR_NOT):
            if stack not in new_stacks:
                new_stacks.append(stack)
        else:
            raise AssertionError("invalid stack top")

    def accept_char(self, chr_: int):
        """whisper_grammar_accept (:5698-5724)."""
        new_stacks: list[tuple[Pos, ...]] = []
        for stack in self.stacks:
            if not stack:
                continue
            ok, after = self._match_char(stack[-1], chr_)
            if ok:
                new_stack = list(stack[:-1])
                if not self._is_end(self._el(after)):
                    new_stack.append(after)
                self._advance(tuple(new_stack), new_stacks)
        self.stacks = new_stacks

    def accept_token(self, token_bytes: bytes):
        """whisper_grammar_accept_token (:5882-5910)."""
        if not self.stacks:
            return
        if token_bytes.startswith(b"[_"):
            return
        code_points, self.partial_utf8 = decode_utf8(token_bytes,
                                                     self.partial_utf8)
        for cp in code_points[:-1]:
            self.accept_char(cp)

    # -- candidate rejection ----------------------------------------------

    def _reject_for_stack(self, stack: tuple[Pos, ...], candidates):
        """candidates: list of (id, cp_offset, code_points, partial)."""
        rejects = []
        if not stack:
            for c in candidates:
                tid, off, cps, partial = c
                if cps[off] != 0 or partial.n_remain != 0:
                    rejects.append(c)
            return rejects

        stack_pos = stack[-1]
        next_candidates = []
        for c in candidates:
            tid, off, cps, partial = c
            if cps[off] == 0:
                if partial.n_remain != 0 and not self._match_partial(stack_pos, partial):
                    rejects.append(c)
            elif self._match_char(stack_pos, cps[off])[0]:
                next_candidates.append((tid, off + 1, cps, partial))
            else:
                rejects.append(c)

        after = self._match_char(stack_pos, 0)[1]
        stack_after = list(stack[:-1])
        if not self._is_end(self._el(after)):
            stack_after.append(after)
        next_stacks: list[tuple[Pos, ...]] = []
        self._advance(tuple(stack_after), next_stacks)

        for tid, off, cps, partial in self._reject(next_stacks, next_candidates):
            rejects.append((tid, off - 1, cps, partial))
        return rejects

    def _reject(self, stacks, candidates):
        if not candidates or not stacks:
            return []
        rejects = self._reject_for_stack(stacks[0], candidates)
        for st in stacks[1:]:
            rejects = self._reject_for_stack(st, rejects)
        return rejects

    def rejected_tokens(self, vocab) -> list[int]:
        """Token ids (< eot) the grammar cannot continue with."""
        if not self.rules or not self.stacks:
            return []
        candidates = []
        for tid in range(vocab.token_eot):
            text = vocab.id_to_token[tid]
            if text:
                cps, partial = decode_utf8(text, self.partial_utf8)
                candidates.append((tid, 0, cps, partial))
        return [c[0] for c in self._reject(self.stacks, candidates)]

    def penalty_mask(self, vocab, penalty: float) -> np.ndarray:
        """(V,) additive mask: -penalty at rejected token ids."""
        mask = np.zeros(vocab.n_vocab, np.float32)
        for tid in self.rejected_tokens(vocab):
            mask[tid] = -penalty
        return mask


# ---------------------------------------------------------------------------
# Token-level DFA compilation (device-loop grammar masking)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GrammarDFA:
    """The pushdown automaton flattened over the token vocabulary.

    Grammar states (stack-sets + partial-utf8) are enumerated by BFS and
    become rows of fixed-shape arrays, so the fused device decode loop can
    apply the reference's grammar penalty (whisper.cpp:6365-6388) and step
    the automaton entirely in-graph:

      mask(s)     = -penalty at every candidate token not in allowed[s]
      step(s, t)  = s            if skip[t]   ("[_" specials / empty text)
                    nxt[s][j]    if allowed[s][j] == t
                    dead         otherwise    (host analog: accept_token on
                                  a non-matching token empties the stacks,
                                  disabling the grammar from then on)

    Built only when the grammar is small enough (see build_token_dfa);
    otherwise decoding stays on the host-stepped path.
    """
    allowed: "np.ndarray"    # (n_states, A) i32 token ids, pad = n_vocab
    nxt: "np.ndarray"        # (n_states, A) i32 successor state
    cand: "np.ndarray"       # (V,) f32 1.0 where the token can be rejected
    skip: "np.ndarray"       # (V,) bool no-state-change tokens
    dead: int                # id of the empty-stacks state

    @property
    def n_states(self) -> int:
        return self.allowed.shape[0]


def build_token_dfa(grammar: "Grammar", vocab, max_states: int = 512,
                    max_transitions: int = 100_000) -> "GrammarDFA | None":
    """BFS-enumerate the grammar's token automaton; None if it exceeds the
    state/transition budget (caller falls back to the host-stepped loop)."""


    V = vocab.n_vocab
    eot = vocab.token_eot
    cand_ids = [tid for tid in range(eot) if vocab.id_to_token[tid]]
    cand = np.zeros(V, np.float32)
    cand[cand_ids] = 1.0
    skip = np.zeros(V, bool)
    for tid in range(V):
        text = vocab.id_to_token[tid] if tid < len(vocab.id_to_token) else b""
        if not text or text.startswith(b"[_"):
            skip[tid] = True

    def key(g):
        return (frozenset(g.stacks),
                (g.partial_utf8.value, g.partial_utf8.n_remain))

    start = grammar.copy()
    states: dict = {key(start): 0}
    glist = [start]
    rows_allowed: list[list[int]] = []
    rows_nxt: list[list[int]] = []
    dead_id = None
    n_transitions = 0
    i = 0
    while i < len(glist):
        g = glist[i]
        i += 1
        if not g.stacks:
            dead_id = len(rows_allowed)
            rows_allowed.append([])
            rows_nxt.append([])
            continue
        rejected = set(g.rejected_tokens(vocab))
        allowed = [t for t in cand_ids if t not in rejected]
        n_transitions += len(allowed)
        if n_transitions > max_transitions:
            return None
        nxt_row = []
        for t in allowed:
            g2 = g.copy()
            g2.accept_token(vocab.id_to_token[t])
            k2 = key(g2)
            if k2 not in states:
                if len(states) >= max_states:
                    return None
                states[k2] = len(glist)
                glist.append(g2)
            nxt_row.append(states[k2])
        rows_allowed.append(allowed)
        rows_nxt.append(nxt_row)

    # rows are appended in BFS visit order == state-id order only when no
    # dead row interleaves; rebuild positionally to be safe
    n = len(glist)
    if len(rows_allowed) != n:
        return None
    if dead_id is None:
        # synthesize an explicit dead state
        dead_id = n
        rows_allowed.append([])
        rows_nxt.append([])
        n += 1
    A = max(1, max(len(r) for r in rows_allowed))
    allowed_arr = np.full((n, A), V, np.int32)
    nxt_arr = np.full((n, A), dead_id, np.int32)
    for s, (ra, rn) in enumerate(zip(rows_allowed, rows_nxt)):
        if ra:
            allowed_arr[s, :len(ra)] = ra
            nxt_arr[s, :len(rn)] = rn
    return GrammarDFA(allowed=allowed_arr, nxt=nxt_arr, cand=cand,
                      skip=skip, dead=dead_id)
