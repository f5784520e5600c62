"""Word timings for word <-> speaker alignment.

Port of the `WordTiming` dataclass of open_whisper_kit_tpu/align/aligner.py
(DiarizationAligner.swift's word record), which `api.words_from_result`
returns. The alignment itself (`align`, the diarized records) is not
ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WordTiming:
    word: str
    start: float
    end: float
    probability: float = 1.0
