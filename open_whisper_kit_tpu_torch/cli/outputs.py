# Source: open_whisper_kit_tpu/cli/outputs.py, copied as it stands (pure Python and numpy, no JAX).
"""Transcript output formats (txt/vtt/srt/csv/json/lrc/wts/score).

Format-exact ports of the reference CLI writers
(examples/cli/cli.cpp:449-925, examples/common-whisper.cpp:138 to_timestamp)
including the stereo channel-energy pseudo-diarization
(estimate_diarization_speaker, cli.cpp:315-347).
"""

from __future__ import annotations

import json
from typing import TextIO

import numpy as np

from ..decode.full import TranscribeResult

SAMPLE_RATE = 16000


def to_timestamp(t: int, comma: bool = False) -> str:
    """Centiseconds -> HH:MM:SS[.,]mmm."""
    msec = t * 10
    hr, msec = divmod(msec, 3600 * 1000)
    mn, msec = divmod(msec, 60 * 1000)
    sec, msec = divmod(msec, 1000)
    sep = "," if comma else "."
    return f"{hr:02d}:{mn:02d}:{sec:02d}{sep}{msec:03d}"


def estimate_channel_speaker(stereo: np.ndarray, t0: int, t1: int,
                             id_only: bool = False) -> str:
    """Stereo channel-energy speaker guess (cli.cpp:315-347)."""
    n = stereo.shape[0]
    is0 = max(0, min(n - 1, t0 * SAMPLE_RATE // 100))
    is1 = max(0, min(n - 1, t1 * SAMPLE_RATE // 100))
    e0 = float(np.abs(stereo[is0:is1, 0]).sum())
    e1 = float(np.abs(stereo[is0:is1, 1]).sum())
    if e0 > 1.1 * e1:
        spk = "0"
    elif e1 > 1.1 * e0:
        spk = "1"
    else:
        spk = "?"
    return spk if id_only else f"(speaker {spk})"


def _speaker(result_seg, stereo, id_only=False) -> str:
    if stereo is None:
        return ""
    return estimate_channel_speaker(stereo, result_seg.t0, result_seg.t1, id_only)


# -- terminal token rendering (print-colors / print-confidence) ---------------

def _rgb_to_xterm256(r: int, g: int, b: int) -> int:
    """24-bit RGB -> xterm256 palette index (common.h:260-276 rgb2xterm256)."""
    def uncube(x):
        return 0 if x < 48 else (1 if x < 115 else (x - 35) // 40)
    cube = (0, 0o137, 0o207, 0o257, 0o327, 0o377)
    av = int(r * 0.299 + g * 0.587 + b * 0.114 + 0.5)
    il = 23 if av > 238 else (av - 3) // 10
    ql = il * 10 + 8
    ir, ig, ib = uncube(r), uncube(g), uncube(b)
    qr, qg, qb = cube[ir], cube[ig], cube[ib]
    if ((qr - r) ** 2 + (qg - g) ** 2 + (qb - b) ** 2
            <= (ql - r) ** 2 + (ql - g) ** 2 + (ql - b) ** 2):
        return ir * 36 + ig * 6 + ib + 0o20
    return il + 0o350


# Paul Tol colour-blind-friendly red→green ramp (common.h:287-295 k_colors).
K_COLORS = tuple(f"\033[38;5;{_rgb_to_xterm256(r, g, b)}m" for r, g, b in (
    (220, 5, 12), (232, 96, 28), (241, 147, 45), (246, 193, 65),
    (247, 240, 86), (144, 201, 135), (78, 178, 101)))

# inverse / underline / dim for low / medium / high confidence
# (common.h:298-315 k_styles).
K_STYLES = ("\033[7m", "\033[4m", "\033[2m")
_RESET = "\033[0m"


def color_for_prob(p: float) -> str:
    """ANSI colour for token probability (cli.cpp:400-405)."""
    col = int(p ** 3 * len(K_COLORS))
    return K_COLORS[max(0, min(len(K_COLORS) - 1, col))]


def style_for_prob(p: float) -> str:
    """ANSI style for token probability (cli.cpp:420-426)."""
    return K_STYLES[0 if p < 0.33 else (1 if p < 0.66 else 2)]


def render_segment_tokens(seg, vocab, *, mode: str, print_special: bool = False,
                          speaker: str = "") -> str:
    """Per-token coloured rendering of one segment (cli.cpp:389-427).

    mode: "colors" (probability ramp) or "confidence" (3-level styles).
    Special tokens (id >= eot) are skipped unless print_special.
    """
    pick = color_for_prob if mode == "colors" else style_for_prob
    parts = []
    for tok in seg.tokens:
        if not print_special and tok.id >= vocab.token_eot:
            continue
        parts.append(f"{speaker}{pick(tok.p)}{vocab.token_to_str(tok.id)}{_RESET}")
    return "".join(parts)


def write_txt(res: TranscribeResult, f: TextIO, stereo=None):
    for s in res.segments:
        f.write(f"{_speaker(s, stereo)}{s.text}\n")


def write_vtt(res: TranscribeResult, f: TextIO, stereo=None):
    f.write("WEBVTT\n\n")
    for s in res.segments:
        spk = ""
        if stereo is not None:
            spk = f"<v Speaker{_speaker(s, stereo, id_only=True)}>"
        f.write(f"{to_timestamp(s.t0)} --> {to_timestamp(s.t1)}\n")
        f.write(f"{spk}{s.text}\n\n")


def write_srt(res: TranscribeResult, f: TextIO, stereo=None, offset_n: int = 0):
    for i, s in enumerate(res.segments):
        f.write(f"{i + 1 + offset_n}\n")
        f.write(f"{to_timestamp(s.t0, True)} --> {to_timestamp(s.t1, True)}\n")
        f.write(f"{_speaker(s, stereo)}{s.text}\n\n")


def write_csv(res: TranscribeResult, f: TextIO, stereo=None):
    f.write("start,end,")
    if stereo is not None:
        f.write("speaker,")
    f.write("text\n")
    for s in res.segments:
        text = s.text.replace('"', '""')
        f.write(f"{10 * s.t0},{10 * s.t1},")
        if stereo is not None:
            f.write(f"{_speaker(s, stereo, id_only=True)},")
        f.write(f'"{text}"\n')


def write_lrc(res: TranscribeResult, f: TextIO, stereo=None):
    f.write("[by:whisper.cpp]\n")
    for s in res.segments:
        msec = s.t0 * 10
        mn, msec = divmod(msec, 60 * 1000)
        sec, msec = divmod(msec, 1000)
        stamp = f"{mn:02d}:{sec:02d}.{msec // 10:02d}"
        f.write(f"[{stamp}]{_speaker(s, stereo)}{s.text}\n")


def write_score(res: TranscribeResult, f: TextIO, vocab=None):
    for s in res.segments:
        for tk in s.tokens:
            tok = vocab.token_to_str(tk.id) if vocab else str(tk.id)
            f.write(f"{tok}\t{tk.p}\n")


def write_json(res: TranscribeResult, f: TextIO, *, full: bool = False,
               model_type: str = "", language: str = "", vocab=None,
               params=None, stereo=None):
    """JSON output mirroring output_json (cli.cpp:637-780)."""
    data = {
        "systeminfo": "open-whisper-kit-tpu (jax/xla)",
        "model": {
            "type": model_type,
            "multilingual": bool(vocab.is_multilingual) if vocab else False,
            "vocab": vocab.n_vocab if vocab else 0,
        },
        "params": {
            "model": model_type,
            "language": language,
            "translate": bool(params.translate) if params else False,
        },
        "result": {"language": language},
        "transcription": [],
    }
    for s in res.segments:
        seg = {
            "timestamps": {
                "from": to_timestamp(s.t0, True),
                "to": to_timestamp(s.t1, True),
            },
            "offsets": {"from": 10 * s.t0, "to": 10 * s.t1},
            "text": s.text,
        }
        if full:
            seg["tokens"] = [
                {
                    "text": vocab.token_to_str(tk.id) if vocab else "",
                    "timestamps": {
                        "from": to_timestamp(tk.t0, True),
                        "to": to_timestamp(tk.t1, True),
                    },
                    "offsets": {"from": 10 * tk.t0, "to": 10 * tk.t1},
                    "id": tk.id,
                    "p": round(float(tk.p), 6),
                    "t_dtw": tk.t_dtw,
                }
                for tk in s.tokens
            ]
        if stereo is not None:
            seg["speaker"] = _speaker(s, stereo, id_only=True)
        if s.speaker_turn_next:
            seg["speaker_turn_next"] = True
        data["transcription"].append(seg)
    json.dump(data, f, indent=2, ensure_ascii=False)
    f.write("\n")


def _g(x: float) -> str:
    """C++ std::ostream double formatting (6 significant digits, %g)."""
    return f"{x:g}"


def write_wts(res: TranscribeResult, f: TextIO, audio_path: str,
              duration_s: float,
              font: str = "/System/Library/Fonts/Supplemental/Courier New Bold.ttf",
              vocab=None, stereo=None):
    """Karaoke ffmpeg script — byte-faithful port of output_wts
    (cli.cpp:772-891): per segment a gray empty marker + gray background
    line, then per token a lightgreen highlight line (token chars kept,
    others '\\ '-blanked, '|' cursor) and an underline line, each enabled
    over the token's [t0, t1]; ' -> U+2019 and " -> \\" escapes; trailing
    echo lines. The font existence check (cli.cpp:777-781) is the caller's
    concern. Needs token_timestamps (the CLI forces it with -owts)."""
    dr = _g(duration_s)
    f.write("#!/bin/bash\n\n")
    f.write(f"ffmpeg -i {audio_path} -f lavfi -i color=size=1200x120:"
            f"duration={dr}:rate=25:color=black -vf \"")
    token_eot = vocab.token_eot if vocab is not None else 10**9

    for i, s in enumerate(res.segments):
        if i > 0:
            f.write(",")
        t0s, t1s = _g(s.t0 / 100.0), _g(s.t1 / 100.0)
        f.write(f"drawtext=fontfile='{font}':fontsize=24:fontcolor=gray:"
                f"x=(w-text_w)/2:y=h/2:text='':enable='between(t,{t0s},{t0s})'")

        speaker = ""
        if stereo is not None:
            speaker = estimate_channel_speaker(stereo, s.t0, s.t1, False)

        texts = [vocab.token_to_str(tk.id) if vocab is not None else ""
                 for tk in s.tokens]
        is_first = True
        for j, tk in enumerate(s.tokens):
            if tk.id >= token_eot:
                continue
            txt_bg = txt_fg = ""
            txt_ul = ""
            if stereo is not None:
                txt_bg = txt_fg = speaker
                txt_ul = "\\ " * 11
            txt_bg += "> "
            txt_fg += "> "
            txt_ul += "\\ \\ "
            for k, tk2 in enumerate(s.tokens):
                if tk2.id >= token_eot:
                    continue
                txt = texts[k]
                txt_bg += txt
                if k == j:
                    txt_fg += txt + "|"
                    txt_ul += "_" * len(txt)
                else:
                    txt_fg += "\\ " * len(txt)
                    txt_ul += "\\ " * len(txt)
            txt_bg = txt_bg.replace("'", "’").replace('"', '\\"')
            txt_fg = txt_fg.replace("'", "’").replace('"', '\\"')

            if is_first:
                f.write(f",drawtext=fontfile='{font}':fontsize=24:"
                        f"fontcolor=gray:x=(w-text_w)/2:y=h/2:"
                        f"text='{txt_bg}':enable='between(t,{t0s},{t1s})'")
                is_first = False

            k0, k1 = _g(tk.t0 / 100.0), _g(tk.t1 / 100.0)
            f.write(f",drawtext=fontfile='{font}':fontsize=24:"
                    f"fontcolor=lightgreen:x=(w-text_w)/2+8:y=h/2:"
                    f"text='{txt_fg}':enable='between(t,{k0},{k1})'")
            f.write(f",drawtext=fontfile='{font}':fontsize=24:"
                    f"fontcolor=lightgreen:x=(w-text_w)/2+8:y=h/2+16:"
                    f"text='{txt_ul}':enable='between(t,{k0},{k1})'")

    f.write(f"\" -c:v libx264 -pix_fmt yuv420p -y {audio_path}.mp4\n")
    f.write("\n\n")
    f.write(f'echo "Your video has been saved to {audio_path}.mp4"\n')
    f.write("\n")
    f.write(f'echo "  ffplay {audio_path}.mp4"\n')
    f.write("\n")
