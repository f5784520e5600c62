# Source: open_whisper_kit_tpu/align/aligner.py, copied as it stands (pure Python and numpy, no JAX).
"""Word <-> speaker alignment (DiarizationAligner).

Behavioral port of Sources/OpenWhisperKit/DiarizationAligner.swift:22-305:
max-overlap speaker assignment (ties broken by first-seen speaker order),
optional nearest-segment fill, sentence-boundary smoothing by majority
speaker (bounded window, sentences end on . ? !), utterance grouping and
the "[speaker]: text" transcript.
"""

from __future__ import annotations

import dataclasses

from .rttm import RttmSegment


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    probability: float = 1.0


@dataclasses.dataclass
class DiarizedWord:
    word: str
    start: float
    end: float
    speaker: str | None
    probability: float = 1.0


@dataclasses.dataclass
class DiarizedUtterance:
    speaker: str | None
    text: str
    start: float
    end: float
    words: list[DiarizedWord]


@dataclasses.dataclass
class DiarizedTranscription:
    words: list[DiarizedWord]
    segments: list[DiarizedUtterance]
    text: str


@dataclasses.dataclass
class AlignmentOptions:
    fill_nearest: bool = False
    sentence_smoothing: bool = True
    max_words_in_sentence: int = 50


def _ends_sentence(text: str) -> bool:
    t = text.strip()
    return bool(t) and t[-1] in ".?!"


def _distance(word_start, word_end, seg: RttmSegment) -> float:
    if word_end < seg.start:
        return seg.start - word_end
    if seg.end < word_start:
        return word_start - seg.end
    return 0.0


def _nearest_speaker(word_start, word_end, segments) -> str | None:
    best = None
    best_d = None
    for seg in segments:
        d = _distance(word_start, word_end, seg)
        if best_d is None or d < best_d or (d == best_d and seg.start < best.start):
            best, best_d = seg, d
    return best.speaker if best else None


def _assign_speaker(word: WordTiming, segments, speaker_order,
                    fill_nearest: bool) -> str | None:
    if not segments:
        return None
    ws = min(word.start, word.end)
    we = max(word.start, word.end)

    if ws == we:
        for seg in segments:
            if seg.start <= ws <= seg.end:
                return seg.speaker
        return _nearest_speaker(ws, we, segments) if fill_nearest else None

    overlap: dict[str, float] = {}
    for seg in segments:
        inter = min(seg.end, we) - max(seg.start, ws)
        if inter > 0:
            overlap[seg.speaker] = overlap.get(seg.speaker, 0.0) + inter
    if overlap:
        # max overlap; ties -> earliest-seen speaker
        return max(overlap.items(),
                   key=lambda kv: (kv[1], -speaker_order.get(kv[0], 1 << 30)))[0]
    if fill_nearest:
        return _nearest_speaker(ws, we, segments)
    return None


def _sentence_start(words, change_idx, max_words) -> int:
    start = max(0, change_idx - 1)
    cursor = change_idx - 1
    steps = 0
    while cursor >= 0 and steps < max_words:
        if _ends_sentence(words[cursor].word):
            return min(change_idx - 1, cursor + 1)
        start = cursor
        cursor -= 1
        steps += 1
    return start


def _sentence_end(words, change_idx, max_words) -> int:
    end = min(len(words) - 1, change_idx)
    cursor = change_idx
    steps = 0
    while cursor < len(words) and steps < max_words:
        end = cursor
        if _ends_sentence(words[cursor].word):
            return end
        cursor += 1
        steps += 1
    return end


def _majority_speaker(words, start, end) -> str | None:
    counts: dict = {}
    first_seen: dict = {}
    seen = 0
    for i in range(start, end + 1):
        spk = words[i].speaker
        counts[spk] = counts.get(spk, 0) + 1
        if spk not in first_seen:
            first_seen[spk] = seen
            seen += 1
    return max(counts.items(),
               key=lambda kv: (kv[1], -first_seen.get(kv[0], 1 << 30)))[0]


def _smooth(words: list[DiarizedWord], max_words: int):
    if len(words) <= 1:
        return
    i = 1
    while i < len(words):
        if words[i].speaker == words[i - 1].speaker:
            i += 1
            continue
        if _ends_sentence(words[i - 1].word):
            i += 1
            continue
        start = _sentence_start(words, i, max_words)
        end = _sentence_end(words, i, max_words)
        spk = _majority_speaker(words, start, end)
        for j in range(start, end + 1):
            words[j].speaker = spk
        i = end + 1


def _group_utterances(words: list[DiarizedWord]) -> list[DiarizedUtterance]:
    if not words:
        return []
    out: list[DiarizedUtterance] = []
    cur: list[DiarizedWord] = [words[0]]
    for w in words[1:]:
        if w.speaker == cur[0].speaker:
            cur.append(w)
        else:
            out.append(_make_utterance(cur))
            cur = [w]
    out.append(_make_utterance(cur))
    return out


def _make_utterance(words: list[DiarizedWord]) -> DiarizedUtterance:
    return DiarizedUtterance(
        speaker=words[0].speaker,
        text=" ".join(w.word for w in words),
        start=words[0].start, end=words[-1].end, words=words)


def align(words: list[WordTiming], segments: list[RttmSegment],
          options: AlignmentOptions | None = None) -> DiarizedTranscription:
    opts = options or AlignmentOptions()
    if opts.max_words_in_sentence <= 0:
        raise ValueError("max_words_in_sentence must be > 0")
    if not words:
        return DiarizedTranscription([], [], "")

    ordered = sorted(enumerate(segments),
                     key=lambda kv: (kv[1].start, kv[0]))
    ordered = [s for _, s in ordered]
    speaker_order: dict[str, int] = {}
    for i, seg in enumerate(ordered):
        speaker_order.setdefault(seg.speaker, i)

    dwords = [DiarizedWord(w.word, w.start, w.end,
                           _assign_speaker(w, ordered, speaker_order,
                                           opts.fill_nearest),
                           w.probability)
              for w in words]

    if opts.sentence_smoothing:
        _smooth(dwords, opts.max_words_in_sentence)

    utterances = _group_utterances(dwords)
    text = "\n".join(f"[{u.speaker or 'unknown'}]: {u.text}" for u in utterances)
    return DiarizedTranscription(dwords, utterances, text)
