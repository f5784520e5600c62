"""Voice chess (wchess analog): grammar-guided move dictation (PyTorch
port of examples/wchess.py).

The reference's examples/wchess (libwchess/Chessboard.cpp + WChess.cpp)
listens on an SDL microphone, constrains whisper decoding with a GBNF
grammar of the currently legal moves, and applies the recognized move to a
simplified chessboard. This port keeps the same capability on the TPU
port without a mic dependency: moves arrive as WAV files, raw s16le
stdin, or plain text (--text, ASR-free board/grammar exercise).

The chessboard matches the reference's scope (libwchess/Chessboard.h:7
"just basic validation ... missing en passant, castling, promotion") but
computes legality the simple exhaustive way (pseudo-legal generation +
king-safety make/unmake test) instead of incremental pin bookkeeping —
same accepted/rejected moves, simpler code. The generated grammar uses
the reference's exact rule shape (move/prompt/piece/frompos/topos,
Chessboard.cpp:545-601) with the 'move' start rule
(wchess: m_wparams.i_start_rule = symbol_ids.at("move")).

Runs on the card unless `-ng` asks for the CPU (`-dev N`: cuda:N).

    python -m open_whisper_kit_tpu_torch.examples.wchess -m ggml-base.en.bin \
        --audio m1.wav m2.wav
    python -m open_whisper_kit_tpu_torch.examples.wchess --text "d4; knight to f3; e5"
"""

from __future__ import annotations

import argparse
import sys

from . import add_device_args, device_of

PIECE_NAMES = ("pawn", "knight", "bishop", "rook", "queen", "king")
WHITE, BLACK = 0, 1
_SHORT = {("pawn", WHITE): "P", ("knight", WHITE): "N", ("bishop", WHITE): "B",
          ("rook", WHITE): "R", ("queen", WHITE): "Q", ("king", WHITE): "K",
          ("pawn", BLACK): "p", ("knight", BLACK): "n", ("bishop", BLACK): "b",
          ("rook", BLACK): "r", ("queen", BLACK): "q", ("king", BLACK): "k"}


def _sq(file: int, rank: int) -> str:
    return chr(ord("a") + file) + str(rank + 1)


def _fr(sq: str) -> tuple[int, int]:
    return ord(sq[0]) - ord("a"), int(sq[1]) - 1


class Chessboard:
    """Simplified chess (reference parity: no castling/en-passant/
    promotion). Squares are 'a1'..'h8' strings; white moves first."""

    def __init__(self):
        self.board: dict[str, tuple[str, int]] = {}
        back = ("rook", "knight", "bishop", "queen", "king",
                "bishop", "knight", "rook")
        for f in range(8):
            self.board[_sq(f, 0)] = (back[f], WHITE)
            self.board[_sq(f, 1)] = ("pawn", WHITE)
            self.board[_sq(f, 6)] = ("pawn", BLACK)
            self.board[_sq(f, 7)] = (back[f], BLACK)
        self.move_counter = 0
        self.prompt = ""

    # -- move generation ---------------------------------------------------

    def _pseudo_moves(self, sq: str) -> list[str]:
        piece, color = self.board[sq]
        f, r = _fr(sq)
        out: list[str] = []

        def push(nf, nr, capture_ok=True, need_capture=False):
            if not (0 <= nf < 8 and 0 <= nr < 8):
                return False
            t = _sq(nf, nr)
            occ = self.board.get(t)
            if occ is None:
                if not need_capture:
                    out.append(t)
                return True                      # slide may continue
            if capture_ok and occ[1] != color:
                out.append(t)
            return False

        def slide(dirs):
            for df, dr in dirs:
                nf, nr = f + df, r + dr
                while push(nf, nr):
                    nf, nr = nf + df, nr + dr

        if piece == "pawn":
            fwd = 1 if color == WHITE else -1
            start = 1 if color == WHITE else 6
            if self.board.get(_sq(f, r + fwd)) is None:
                push(f, r + fwd, capture_ok=False)
                if r == start and self.board.get(_sq(f, r + 2 * fwd)) is None:
                    push(f, r + 2 * fwd, capture_ok=False)
            for df in (-1, 1):
                push(f + df, r + fwd, need_capture=True)
        elif piece == "knight":
            for df, dr in ((1, 2), (2, 1), (2, -1), (1, -2), (-1, -2),
                           (-2, -1), (-2, 1), (-1, 2)):
                push(f + df, r + dr)
        elif piece == "bishop":
            slide(((1, 1), (1, -1), (-1, 1), (-1, -1)))
        elif piece == "rook":
            slide(((1, 0), (-1, 0), (0, 1), (0, -1)))
        elif piece == "queen":
            slide(((1, 1), (1, -1), (-1, 1), (-1, -1),
                   (1, 0), (-1, 0), (0, 1), (0, -1)))
        elif piece == "king":
            for df in (-1, 0, 1):
                for dr in (-1, 0, 1):
                    if df or dr:
                        push(f + df, r + dr)
        return out

    def _attacked(self, sq: str, by_color: int) -> bool:
        for s, (piece, color) in self.board.items():
            if color != by_color:
                continue
            if piece == "pawn":
                f, r = _fr(s)
                fwd = 1 if color == WHITE else -1
                for df in (-1, 1):
                    nf, nr = f + df, r + fwd
                    if 0 <= nf < 8 and 0 <= nr < 8 and _sq(nf, nr) == sq:
                        return True
            elif sq in self._pseudo_moves(s):
                return True
        return False

    def _king_sq(self, color: int) -> str:
        for s, (piece, c) in self.board.items():
            if piece == "king" and c == color:
                return s
        raise ValueError("no king")

    def legal_moves(self, sq: str) -> list[str]:
        """Fully legal destinations for the piece at sq (king-safety via
        make/unmake — equivalent outcomes to the reference's pin/check
        tracking, Chessboard.cpp:574-640)."""
        piece, color = self.board[sq]
        out = []
        for t in self._pseudo_moves(sq):
            taken = self.board.get(t)
            self.board[t] = self.board.pop(sq)
            if not self._attacked(self._king_sq(color), 1 - color):
                out.append(t)
            self.board[sq] = self.board.pop(t)
            if taken is not None:
                self.board[t] = taken
        return sorted(out)

    def in_check(self) -> bool:
        color = self.move_counter % 2
        return self._attacked(self._king_sq(color), 1 - color)

    # -- command processing (Chessboard::process) --------------------------

    def process(self, command: str) -> str:
        """'knight to c3' / 'd2 to d4' / 'd4' -> 'b1-c3' or '' if illegal;
        '#' appended when the opponent then has no legal move."""
        color = self.move_counter % 2
        tokens = [t for t in command.replace(",", " ").lower().split()
                  if t != "to"]
        if self.prompt:
            # strip a leading recognized prompt (wchess prepends it),
            # normalized the same way as the command tokens
            pw = [t for t in self.prompt.replace(",", " ").lower().split()
                  if t != "to"]
            if tokens[:len(pw)] == pw:
                tokens = tokens[len(pw):]
        if not tokens:
            return ""
        pos_from, ptype, pos_to = None, None, tokens[-1]
        if len(tokens) == 1:
            ptype = "pawn"
        elif tokens[0] in PIECE_NAMES:
            ptype = tokens[0]
        else:
            pos_from = tokens[0]
        if not (len(pos_to) == 2 and "a" <= pos_to[0] <= "h"
                and "1" <= pos_to[1] <= "8"):
            return ""
        if pos_from is None:
            for s in sorted(self.board):
                p = self.board[s]
                if (p[1] == color and p[0] == ptype
                        and pos_to in self.legal_moves(s)):
                    pos_from = s
                    break
            if pos_from is None:
                return ""
        p = self.board.get(pos_from)
        if p is None or p[1] != color:
            return ""
        if pos_to not in self.legal_moves(pos_from):
            return ""
        self.board[pos_to] = self.board.pop(pos_from)
        self.move_counter += 1
        self.prompt = ""
        result = f"{pos_from}-{pos_to}"
        if not self.grammar():
            result += "#"
        return result

    # -- grammar (Chessboard::setGrammar) ----------------------------------

    def grammar(self) -> str:
        """GBNF of the side-to-move's legal commands (reference rule shape,
        Chessboard.cpp:545-601); empty when no legal move exists."""
        color = self.move_counter % 2
        piece_types, from_pos, to_pos = set(), set(), set()
        for s in sorted(self.board):
            piece, c = self.board[s]
            if c != color:
                continue
            moves = self.legal_moves(s)
            if moves:
                piece_types.add(piece)
                from_pos.add(s)
                to_pos.update(moves)
        if not piece_types:
            return ""
        if not self.prompt:
            head = 'move ::= " " ((piece | frompos) " " "to "?)? topos\n'
        else:
            head = ('move ::= prompt " " frompos " " "to "? topos\n'
                    f'prompt ::= " {self.prompt}"\n')
        names = [n for n in PIECE_NAMES if n in piece_types]
        piece = "piece ::= (" + " |".join(f' "{n}"' for n in names) + ")\n\n"
        frm = ("frompos ::= ("
               + " |".join(f' "{p}"' for p in sorted(from_pos)) + ")\n")
        to = ("topos ::= ("
              + " |".join(f' "{p}"' for p in sorted(to_pos)) + ")\n")
        return head + piece + frm + to

    def set_prompt(self, prompt: str) -> None:
        self.prompt = prompt

    def stringify_board(self) -> str:
        out = []
        for r in range(7, -1, -1):
            row = [str(r + 1)]
            for f in range(8):
                p = self.board.get(_sq(f, r))
                row.append(_SHORT[p] if p else ".")
            out.append(" ".join(row))
        out.append("  a b c d e f g h")
        return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-m", "--model", help="ggml model path (omit with --text)")
    ap.add_argument("--audio", nargs="*", default=[],
                    help="one WAV per move, in order")
    ap.add_argument("--text", default=None,
                    help="semicolon-separated spoken moves (skips ASR)")
    ap.add_argument("--grammar-penalty", type=float, default=100.0)
    add_device_args(ap)
    args = ap.parse_args(argv)

    board = Chessboard()
    print(board.stringify_board())

    def turn():
        return "White" if board.move_counter % 2 == 0 else "Black"

    if args.text is not None:
        commands = [c.strip() for c in args.text.split(";") if c.strip()]
        for cmd in commands:
            res = board.process(cmd)
            print(f"{turn() if not res else ''}{cmd!r} -> {res or 'illegal'}")
            print(board.stringify_board())
        return 0

    if not args.model:
        ap.error("--model required unless --text is given")
    import numpy as np

    from ..audio import wav as wav_mod
    from ..decode import full as F
    from ..decode.grammar import Grammar
    from ..decode.params import FullParams

    ctx = F.WhisperContext.from_file(args.model, device=device_of(args))
    for path in args.audio:
        g = board.grammar()
        if not g:
            print("game over")
            break
        print(f"{turn()} to move; say e.g. 'knight to f3'")
        audio = wav_mod.load_wav(path)
        p = FullParams(print_progress=False, single_segment=True,
                       no_timestamps=True,
                       grammar_rules=Grammar.from_gbnf(g, start="move"),
                       grammar_penalty=args.grammar_penalty)
        p.temperature_inc = 0
        res = F.whisper_full(ctx, p, audio.astype(np.float32))
        text = "".join(s.text for s in res.segments).strip()
        print(f"heard: {text!r}")
        mv = board.process(text)
        print(f"move: {mv or 'not recognized'}")
        print(board.stringify_board())
    return 0


if __name__ == "__main__":
    sys.exit(main())
