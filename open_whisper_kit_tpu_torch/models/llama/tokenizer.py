# Source: open_whisper_kit_tpu/models/llama/tokenizer.py, copied as it stands (pure Python and numpy).
"""LLaMA-family tokenizers reconstructed from GGUF metadata.

Independent reimplementation of the reference's vocab layer
(/root/reference/examples/talk-llama/llama-vocab.cpp):

* SPM (``tokenizer.ggml.model == "llama"``): score-driven bigram merging
  over UTF-8 characters with byte fallback and U+2581 whitespace
  escaping (llama-vocab.cpp:96-199, 2890-2955).
* BPE (``tokenizer.ggml.model == "gpt2"``): rank-driven merges from
  ``tokenizer.ggml.merges`` over GPT-2 byte-mapped text.

Special / control / user-defined tokens partition the raw text before
the sub-word pass (tokenizer_st_partition, llama-vocab.cpp:2700-2780);
here that is a longest-first literal scan, which is equivalent for the
disjoint special-token strings real vocabs use.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

# token_type values (gguf enum llama_token_type)
ATTR_NORMAL = 1
ATTR_UNKNOWN = 2
ATTR_CONTROL = 3
ATTR_USER_DEFINED = 4
ATTR_UNUSED = 5
ATTR_BYTE = 6

_SPACE = "▁"  # ▁ escaped-space symbol (llama-vocab.cpp:833)

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _gpt2_split(text: str) -> list[str]:
    """GPT-2 pre-tokenizer (the classic tiktoken/llama-vocab.cpp gpt2
    regex_exprs pattern, Unicode classes):

        's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
        |\\s+(?!\\S)|\\s+

    Hand-rolled scanner (stdlib `re` has no \\p classes); `\\s+(?!\\S)`
    backtracking semantics — a whitespace run before a word yields its last
    space to the next word's ' ?' prefix — are reproduced exactly."""
    import unicodedata

    def cat(c: str) -> str:
        k = unicodedata.category(c)[0]
        return k if k in ("L", "N") else ("S" if c.isspace() else "P")

    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        matched = False
        for suf in _CONTRACTIONS:
            if text.startswith(suf, i):
                out.append(suf)
                i += len(suf)
                matched = True
                break
        if matched:
            continue
        start = i
        k = i + 1 if (text[i] == " " and i + 1 < n) else i
        kc = cat(text[k]) if k < n else "S"
        if kc in ("L", "N", "P") and not (k > i and kc == "S"):
            j = k
            while j < n and cat(text[j]) == kc:
                # '[^\s L N]+' must not swallow contraction starts? The
                # regex has no such carve-out: alternation order only
                # matters at the MATCH START, so "'s" inside a punct run
                # stays split at the next scan position, exactly like
                # re.findall does.
                j += 1
            if j > k:
                out.append(text[start:j])
                i = j
                continue
        # whitespace run: \s+(?!\S) leaves the last space to prefix the
        # following word; \s+ takes everything at end-of-string
        j = i
        while j < n and text[j].isspace():
            j += 1
        if j < n and j - i > 1:
            out.append(text[i:j - 1])
            i = j - 1
        else:
            out.append(text[i:j])
            i = j
    return out


def _gpt2_byte_maps():
    """GPT-2 printable-byte bijection (same table whisper's BPE uses)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    byte_to_uni = {b: chr(c) for b, c in zip(bs, cs)}
    uni_to_byte = {chr(c): b for b, c in zip(bs, cs)}
    return byte_to_uni, uni_to_byte


@dataclasses.dataclass
class LlamaVocab:
    model: str                       # "llama" (SPM) | "gpt2" (BPE)
    tokens: list[str]
    scores: np.ndarray               # f32, SPM merge priority
    token_type: np.ndarray           # i32 attr enum
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 0
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    merges: list[str] | None = None  # BPE only

    def __post_init__(self):
        self.text_to_id = {}
        for i, t in enumerate(self.tokens):
            self.text_to_id.setdefault(t, i)
        self.byte_to_id = {}
        for i, t in enumerate(self.tokens):
            if (self.token_type[i] == ATTR_BYTE and len(t) == 6
                    and t.startswith("<0x")):
                self.byte_to_id[int(t[3:5], 16)] = i
        self.special = sorted(
            (t for i, t in enumerate(self.tokens)
             if self.token_type[i] in (ATTR_CONTROL, ATTR_USER_DEFINED) and t),
            key=len, reverse=True)
        if self.model == "gpt2":
            self._b2u, self._u2b = _gpt2_byte_maps()
            self.merge_rank = {}
            for r, m in enumerate(self.merges or []):
                a, _, b = m.partition(" ")
                self.merge_rank[(a, b)] = r

    @classmethod
    def from_gguf_metadata(cls, meta: dict) -> "LlamaVocab":
        g = lambda k, d=None: meta.get("tokenizer.ggml." + k, d)
        tokens = list(g("tokens"))
        n = len(tokens)
        scores = np.asarray(g("scores", np.zeros(n, np.float32)), np.float32)
        ttype = np.asarray(g("token_type", np.full(n, ATTR_NORMAL)), np.int32)
        model = g("model", "llama")
        return cls(
            model=model, tokens=tokens, scores=scores, token_type=ttype,
            bos_id=int(g("bos_token_id", 1)),
            eos_id=int(g("eos_token_id", 2)),
            unk_id=int(g("unknown_token_id", 0)),
            add_bos=bool(g("add_bos_token", model == "llama")),
            add_eos=bool(g("add_eos_token", False)),
            add_space_prefix=bool(g("add_space_prefix", model == "llama")),
            merges=list(g("merges")) if g("merges") is not None else None,
        )

    # -- special-token partition ------------------------------------------

    def _partition(self, text: str, parse_special: bool):
        """Split text into (is_token, payload) fragments on special tokens."""
        if not parse_special or not self.special:
            return [(False, text)] if text else []
        frags = []
        rest = text
        while rest:
            best = None
            for sp in self.special:           # longest special first
                j = rest.find(sp)
                if j != -1 and (best is None or j < best[0]
                                or (j == best[0] and len(sp) > len(best[1]))):
                    best = (j, sp)
            if best is None:
                frags.append((False, rest))
                break
            j, sp = best
            if j:
                frags.append((False, rest[:j]))
            frags.append((True, self.text_to_id[sp]))
            rest = rest[j + len(sp):]
        return frags

    # -- SPM --------------------------------------------------------------

    def _spm_tokenize(self, text: str, out: list[int]):
        text = text.replace(" ", _SPACE)
        # UTF-8 character symbols as byte-slices of the encoded text
        data = text.encode("utf-8")
        syms: list[tuple[int, int]] = []     # (offset, length) into data
        off = 0
        while off < len(data):
            b = data[off]
            ln = 1 if b < 0x80 else 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            ln = min(ln, len(data) - off)
            syms.append((off, ln))
            off += ln
        nxt = list(range(1, len(syms))) + [-1]
        prv = [-1] + list(range(len(syms) - 1))
        alive = [True] * len(syms)
        rev_merge: dict[bytes, int] = {}     # piece -> left-child byte length

        heap: list[tuple[float, int, int, int]] = []  # (-score, left, right, size)

        def lookup(piece: bytes):
            txt = piece.decode("utf-8", "ignore")
            tid = self.text_to_id.get(txt)
            return tid if tid is not None and txt.encode("utf-8") == piece \
                else None

        def try_add(left, right):
            if left == -1 or right == -1:
                return
            lo, lsz = syms[left]
            _, rsz = syms[right]
            tid = lookup(data[lo:lo + lsz + rsz])
            if tid is None:
                return
            heapq.heappush(heap, (-float(self.scores[tid]), left, right,
                                  lsz + rsz))

        for i in range(1, len(syms)):
            try_add(i - 1, i)

        while heap:
            nscore, left, right, size = heapq.heappop(heap)
            lo, lsz = syms[left]
            ro, rsz = syms[right]
            if not alive[left] or not alive[right] or lsz + rsz != size:
                continue
            rev_merge[data[lo:lo + lsz + rsz]] = lsz
            syms[left] = (lo, lsz + rsz)
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] != -1:
                prv[nxt[right]] = left
            try_add(prv[left], left)
            try_add(left, nxt[left])

        def resegment(o: int, ln: int):
            """Emit token ids for the byte span [o, o+ln): vocab hit, else
            recurse through the recorded merge, else byte fallback
            (llama-vocab.cpp:142-163 resegment)."""
            piece = data[o:o + ln]
            tid = lookup(piece)
            if tid is not None:
                out.append(tid)
                return
            split = rev_merge.get(piece)
            if split is None:
                for b in piece:
                    out.append(self.byte_to_id.get(b, self.unk_id))
                return
            resegment(o, split)
            resegment(o + split, ln - split)

        i = 0
        while i != -1 and syms:
            o, ln = syms[i]
            resegment(o, ln)
            i = nxt[i]

    # -- BPE --------------------------------------------------------------

    def _bpe_tokenize(self, text: str, out: list[int]):
        for w in _gpt2_split(text):
            units = [self._b2u[b] for b in w.encode("utf-8")]
            while len(units) > 1:
                best, bi = None, -1
                for i in range(len(units) - 1):
                    r = self.merge_rank.get((units[i], units[i + 1]))
                    if r is not None and (best is None or r < best):
                        best, bi = r, i
                if best is None:
                    break
                units[bi:bi + 2] = [units[bi] + units[bi + 1]]
            for u in units:
                tid = self.text_to_id.get(u)
                if tid is None:
                    for c in u:
                        out.append(self.text_to_id.get(c, self.unk_id))
                else:
                    out.append(tid)

    # -- public API -------------------------------------------------------

    def encode(self, text: str, add_special: bool = True,
               parse_special: bool = False) -> list[int]:
        out: list[int] = []
        if add_special and self.add_bos:
            out.append(self.bos_id)
        prev_special = True
        for is_tok, payload in self._partition(text, parse_special):
            if is_tok:
                out.append(payload)
                prev_special = True
            else:
                frag = payload
                if self.model == "llama":
                    if self.add_space_prefix and prev_special:
                        frag = " " + frag
                    self._spm_tokenize(frag, out)
                else:
                    self._bpe_tokenize(frag, out)
                prev_special = False
        if add_special and self.add_eos:
            out.append(self.eos_id)
        return out

    def piece(self, tid: int, special: bool = False) -> str:
        t = self.tokens[tid]
        a = self.token_type[tid]
        if a == ATTR_BYTE:
            return chr(int(t[3:5], 16)) if self.model == "llama" else t
        if a in (ATTR_CONTROL, ATTR_UNKNOWN) and not special:
            return ""
        if self.model == "llama":
            return t.replace(_SPACE, " ")
        return bytes(self._u2b.get(c, ord("?")) for c in t).decode(
            "utf-8", "replace")

    def decode(self, ids, special: bool = False) -> str:
        if self.model == "llama":
            byts = bytearray()
            for tid in ids:
                t = self.tokens[tid]
                a = self.token_type[tid]
                if a == ATTR_BYTE:
                    byts.append(int(t[3:5], 16))
                elif a in (ATTR_CONTROL, ATTR_UNKNOWN) and not special:
                    pass
                else:
                    byts += t.replace(_SPACE, " ").encode("utf-8")
            s = byts.decode("utf-8", "replace")
        else:
            s = "".join(self.piece(t, special) for t in ids)
        if self.model == "llama" and self.add_space_prefix and s.startswith(" "):
            s = s[1:]
        return s
