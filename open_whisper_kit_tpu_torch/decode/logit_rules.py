"""Whisper decode-time logit rules + sampling, vectorized over beams.

Port of open_whisper_kit_tpu/decode/logit_rules.py: whisper_process_logits
(src/whisper.cpp:6177-6445) and whisper_sample_token (:6460-6508) as torch
ops over a (B, V) logits batch on the logits' device, so the token loop
never needs the host.

Static (per-run) suppression sets are precomputed into additive masks
(numpy, shared with the JAX package's semantics); dynamic rules (timestamp
pairing, monotonicity, logsumexp timestamp-vs-text) are driven by small
per-beam state tensors; `sample_topk` expands beams for beam search.
A grammar's additive penalty rows (`apply_rules(grammar_mask=)`) apply
after the timestamp rules, as whisper.cpp's do.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from .tokenizer import NON_SPEECH_TOKENS, WhisperVocab

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class RuleConfig:
    """Static rule configuration."""
    n_vocab: int
    token_eot: int
    token_beg: int
    no_timestamps: bool = False


def build_static_masks(vocab: WhisperVocab, *, suppress_blank: bool = True,
                       no_timestamps: bool = False, tdrz_enable: bool = False,
                       suppress_nst: bool = False,
                       suppress_regex: str | None = None,
                       max_initial_ts: float = 1.0,
                       n_audio_ctx: int = 1500) -> tuple[np.ndarray, np.ndarray]:
    """Return (base_mask, initial_mask), each (V,) f32 of {0, -inf}.

    base_mask applies at every step; initial_mask additionally at the first
    sampled token of a segment (src/whisper.cpp:6214-6322).
    """
    V = vocab.n_vocab
    base = np.zeros(V, np.float32)
    init = np.zeros(V, np.float32)

    def sup(mask, tid):
        if 0 <= tid < V:
            mask[tid] = NEG_INF

    # blank suppression at segment start
    if suppress_blank:
        sup(init, vocab.token_eot)
        sp = vocab.token_to_id.get(b" ")
        if sp is not None:
            sup(init, sp)

    sup(base, vocab.token_not)
    if no_timestamps:
        base[vocab.token_beg:] = NEG_INF

    sup(base, vocab.token_sot)
    sup(base, vocab.token_nosp)
    if not tdrz_enable:
        sup(base, vocab.token_solm)
    sup(base, vocab.token_translate)
    sup(base, vocab.token_transcribe)
    sup(base, vocab.token_prev)

    # language tokens
    for i in range(vocab.num_languages):
        sup(base, vocab.token_lang(i))

    if suppress_regex:
        pat = re.compile(suppress_regex)
        for tok, tid in vocab.token_to_id.items():
            try:
                s = tok.decode("utf-8")
            except UnicodeDecodeError:
                continue
            if pat.fullmatch(s):
                sup(base, tid)

    if suppress_nst:
        for token in NON_SPEECH_TOKENS:
            for s in (token, " " + token):
                tid = vocab.token_to_id.get(s.encode("utf-8"))
                if tid is not None:
                    sup(base, tid)
        for s in (" -", " '"):
            tid = vocab.token_to_id.get(s.encode("utf-8"))
            if tid is not None:
                sup(base, tid)

    # initial timestamp cap (src/whisper.cpp:6317-6325); precision = 30/1500 s
    if max_initial_ts > 0:
        precision = 30.0 / n_audio_ctx
        tid0 = int(round(max_initial_ts / precision))
        init[vocab.token_beg + tid0 + 1:] = NEG_INF

    return base, init


@dataclasses.dataclass
class BeamState:
    """Per-beam dynamic rule inputs, all shape (B,) tensors."""
    is_initial: torch.Tensor      # bool: no sampled tokens yet this segment
    last_was_ts: torch.Tensor     # bool: last sampled token >= token_beg
    penult_was_ts: torch.Tensor   # bool: <2 tokens or tokens[-2] >= token_beg
    has_ts: torch.Tensor          # bool: a timestamp was accepted
    ts_min: torch.Tensor          # int: token_beg + seek_delta/2 floor when has_ts


def apply_rules(rc: RuleConfig, logits: torch.Tensor, base_mask: torch.Tensor,
                init_mask: torch.Tensor, st: BeamState, temperature: float,
                grammar_mask: torch.Tensor | None = None):
    """(B,V) raw logits -> (filtered logits, logprobs, probs), f32.

    Order of operations matches whisper_process_logits exactly.
    `grammar_mask` (B,V): additive penalties applied only when the
    timestamp-force rule did not fire, with logprobs recomputed
    (whisper.cpp:6365-6388)."""
    V = rc.n_vocab
    logits = logits.float()
    if temperature > 0.0:
        logits = logits / max(temperature, 1e-8)

    ids = torch.arange(V, device=logits.device)[None, :]      # (1, V)
    logits = logits + base_mask[None, :]
    logits = torch.where(st.is_initial[:, None], logits + init_mask[None, :], logits)

    is_ts = ids >= rc.token_beg                                # (1, V)
    # timestamps appear in pairs (whisper.cpp:6292-6312)
    both = (st.last_was_ts & st.penult_was_ts)[:, None]
    only_last = (st.last_was_ts & ~st.penult_was_ts)[:, None]
    logits = torch.where(both & is_ts, NEG_INF, logits)
    logits = torch.where(only_last & (ids < rc.token_eot), NEG_INF, logits)

    # monotonic timestamps (whisper.cpp:6327-6334)
    mono = st.has_ts[:, None] & is_ts & (ids < st.ts_min[:, None])
    logits = torch.where(mono, NEG_INF, logits)

    logprobs = torch.log_softmax(logits, dim=-1)

    # timestamp-vs-text logsumexp rule (whisper.cpp:6340-6361)
    ts_logprob = torch.logsumexp(torch.where(is_ts, logprobs, NEG_INF), dim=-1)
    max_text = torch.where(is_ts, NEG_INF, logprobs).max(dim=-1).values
    force_ts = (ts_logprob > max_text)[:, None]
    logits = torch.where(force_ts & ~is_ts, NEG_INF, logits)
    logprobs = torch.where(force_ts & ~is_ts, NEG_INF, logprobs)

    if grammar_mask is not None:
        logits = logits + torch.where(force_ts, 0.0, grammar_mask)
        # force_ts rows keep their unrenormalized logprobs
        logprobs = torch.where(force_ts, logprobs, torch.log_softmax(logits, dim=-1))

    probs = torch.where(torch.isneginf(logits), 0.0, torch.exp(logprobs))
    return logits, logprobs, probs


def ts_aggregates(rc: RuleConfig, probs: torch.Tensor):
    """(pt, ptsum, tid) per beam (whisper_sample_token, whisper.cpp:6476-6492)."""
    p_ts = probs[:, rc.token_beg:]
    ptsum = p_ts.sum(dim=-1)
    max_ts, arg = p_ts.max(dim=-1)
    tid = rc.token_beg + arg
    pt = max_ts / (ptsum + 1e-10)
    return pt, ptsum, tid


def _gather(x: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    return x.gather(1, tok[:, None])[:, 0]


def sample_greedy(rc: RuleConfig, logits, logprobs, probs):
    """argmax sample + timestamp aggregates -> small per-beam tensors
    (tok, p, plog, pt, ptsum, tid)."""
    tok = probs.argmax(dim=-1)
    pt, ptsum, tid = ts_aggregates(rc, probs)
    return tok, _gather(probs, tok), _gather(logprobs, tok), pt, ptsum, tid


def sample_multinomial(rc: RuleConfig, generator: torch.Generator,
                       logits, logprobs, probs):
    """One draw per beam from softmax(logprobs) over the unmasked tokens,
    by the Gumbel-max trick on uniforms from `generator` (which must live
    on the logits' device). The JAX side draws the same distribution from
    jax.random; the numbers differ."""
    u = torch.rand(logprobs.shape, generator=generator, device=logprobs.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    tok = torch.where(torch.isneginf(logits), NEG_INF, logprobs + gumbel).argmax(dim=-1)
    pt, ptsum, tid = ts_aggregates(rc, probs)
    return tok, _gather(probs, tok), _gather(logprobs, tok), pt, ptsum, tid


def sample_topk(rc: RuleConfig, k: int, logits, logprobs, probs):
    """Deterministic top-k beam candidates per beam -> (top_id, top_p,
    top_lp) each (B, k), and the timestamp aggregates (pt, ptsum, tid).

    The order is jax.lax.top_k's: larger logprob first, the lower token id
    first among equal values. Equal values are common (every masked entry
    is -inf) and torch.topk orders ties as it likes on CUDA, so the ids
    come from a stable descending sort instead. As in the JAX package, this
    is the standard deterministic expansion, not whisper.cpp's k draws
    (whisper_sample_token_topk, whisper.cpp:6519-6592)."""
    top_lp, top_id = torch.sort(logprobs, dim=-1, descending=True, stable=True)
    top_lp, top_id = top_lp[:, :k], top_id[:, :k]
    top_p = probs.gather(1, top_id)
    pt, ptsum, tid = ts_aggregates(rc, probs)
    return top_id, top_p, top_lp, pt, ptsum, tid


def compute_no_speech_prob(logits: torch.Tensor, token_nosp: int) -> torch.Tensor:
    """softmax prob of the no-speech token from *unfiltered* logits
    (whisper.cpp:7187-7196); logits (V,), or (B, V) for one per row."""
    return torch.exp(torch.log_softmax(logits.float(), dim=-1)[..., token_nosp])
