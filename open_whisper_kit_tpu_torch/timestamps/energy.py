# Source: open_whisper_kit_tpu/timestamps/energy.py, copied as it stands (pure Python and numpy, no JAX).
"""Token-level timestamps, energy/heuristic algorithm.

Port of whisper_exp_compute_token_level_timestamps + helpers
(src/whisper.cpp:8398-8680): seed token times from accepted timestamp
tokens, proportionally split unknown intervals by the voice_length
heuristic, then expand/contract against a windowed signal-energy envelope.

Note the reference indexes the whole-audio energy array with
segment-relative sample positions (timestamp_to_sample, whisper.cpp:8443-8448);
we reproduce that behavior for output parity.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000


def voice_length(text: str) -> float:
    """Pronunciation-length heuristic (whisper.cpp:8398-8422)."""
    res = 0.0
    for ch in text:
        if ch == " ":
            res += 0.01
        elif ch == ",":
            res += 2.0
        elif ch in ".!?":
            res += 3.0
        elif "0" <= ch <= "9":
            res += 3.0
        else:
            res += 1.0
    return res


def get_signal_energy(signal: np.ndarray, half_window: int = 32) -> np.ndarray:
    """Moving average of |signal| (whisper.cpp:8425-8442), vectorized."""
    hw = half_window
    a = np.abs(signal.astype(np.float32))
    c = np.concatenate([[0.0], np.cumsum(a, dtype=np.float64)])
    n = a.shape[0]
    i = np.arange(n)
    lo = np.maximum(i - hw, 0)
    hi = np.minimum(i + hw, n - 1)
    return ((c[hi + 1] - c[lo]) / (2 * hw + 1)).astype(np.float32)


def _ts_to_sample(t: int, segment_t0: int, n_samples: int) -> int:
    rel = t - segment_t0
    s = int((rel * SAMPLE_RATE) // 100)
    return max(0, min(n_samples - 1, s))


def _sample_to_ts(i_sample: int, segment_t0: int) -> int:
    return (100 * i_sample) // SAMPLE_RATE + segment_t0


class TimestampState:
    """Rolling cross-segment state (whisper_state t_beg/t_last/tid_last)."""

    def __init__(self, energy: np.ndarray):
        self.t_beg = 0
        self.t_last = 0
        self.tid_last = 0
        self.energy = energy


def compute_token_level_timestamps(ctx, result, i_segment: int,
                                   thold_pt: float, thold_ptsum: float):
    """Fill t0/t1 on the tokens of result.segments[i_segment]."""
    st: TimestampState | None = getattr(result, "_ts_state", None)
    if st is None or st.energy.shape[0] == 0:
        return
    vocab = ctx.vocab
    segment = result.segments[i_segment]
    tokens = segment.tokens
    n_samples = st.energy.shape[0]

    t0, t1 = segment.t0, segment.t1
    n = len(tokens)
    if n == 0:
        return
    if n == 1:
        tokens[0].t0, tokens[0].t1 = t0, t1
        return

    for j, token in enumerate(tokens):
        if j == 0:
            if token.id == vocab.token_beg:
                tokens[0].t0 = t0
                tokens[0].t1 = t0
                tokens[1].t0 = t0
                st.t_beg = t0
                st.t_last = t0
                st.tid_last = vocab.token_beg
            else:
                tokens[0].t0 = st.t_last

        tt = st.t_beg + 2 * (token.tid - vocab.token_beg)
        token.vlen = voice_length(vocab.token_to_str(token.id))

        if (token.pt > thold_pt and token.ptsum > thold_ptsum
                and token.tid > st.tid_last and tt <= t1):
            if j > 0:
                tokens[j - 1].t1 = tt
            tokens[j].t0 = tt
            st.tid_last = token.tid

    tokens[n - 2].t1 = t1
    tokens[n - 1].t0 = t1
    tokens[n - 1].t1 = t1
    st.t_last = t1

    # proportional split of unknown intervals by vlen (whisper.cpp:8585-8620)
    p0 = 0
    p1 = 0
    while True:
        while p1 < n and tokens[p1].t1 < 0:
            p1 += 1
        if p1 >= n:
            p1 = n - 1
        if p1 > p0:
            psum = sum(tokens[j].vlen for j in range(p0, p1 + 1))
            dt = tokens[p1].t1 - tokens[p0].t0
            for j in range(p0 + 1, p1 + 1):
                ct = tokens[j - 1].t0 + dt * tokens[j - 1].vlen / psum
                tokens[j - 1].t1 = int(ct)
                tokens[j].t0 = int(ct)
        p1 += 1
        p0 = p1
        if p1 >= n:
            break

    # fix-ups
    for j in range(n - 1):
        if tokens[j].t1 < 0:
            tokens[j + 1].t0 = tokens[j].t1
        if j > 0 and tokens[j - 1].t1 > tokens[j].t0:
            tokens[j].t0 = tokens[j - 1].t1
            tokens[j].t1 = max(tokens[j].t0, tokens[j].t1)

    # energy-based expand/contract (whisper.cpp:8630-8680)
    energy = st.energy
    hw = SAMPLE_RATE // 8
    for j in range(n):
        if tokens[j].id >= vocab.token_eot:
            continue
        s0 = _ts_to_sample(tokens[j].t0, segment.t0, n_samples)
        s1 = _ts_to_sample(tokens[j].t1, segment.t0, n_samples)
        ss0 = max(s0 - hw, 0)
        ss1 = min(s1 + hw, n_samples)
        ns = ss1 - ss0
        if ns <= 0:
            continue
        thold = 0.5 * float(energy[ss0:ss1].sum()) / ns

        k = s0
        if energy[k] > thold and j > 0:
            while k > 0 and energy[k] > thold:
                k -= 1
            tokens[j].t0 = _sample_to_ts(k, segment.t0)
            if tokens[j].t0 < tokens[j - 1].t1:
                tokens[j].t0 = tokens[j - 1].t1
            else:
                s0 = k
        else:
            while k < s1 and energy[k] < thold:
                k += 1
            s0 = k
            tokens[j].t0 = _sample_to_ts(k, segment.t0)

        k = s1
        if energy[k] > thold:
            while k < n_samples - 1 and energy[k] > thold:
                k += 1
            tokens[j].t1 = _sample_to_ts(k, segment.t0)
            if j < n - 1 and tokens[j].t1 > tokens[j + 1].t0:
                tokens[j].t1 = tokens[j + 1].t0
            else:
                s1 = k
        else:
            while k > s0 and energy[k] < thold:
                k -= 1
            s1 = k
            tokens[j].t1 = _sample_to_ts(k, segment.t0)
