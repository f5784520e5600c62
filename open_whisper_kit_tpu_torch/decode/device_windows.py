"""Multi-window decode: up to K 30 s windows per call (port of
open_whisper_kit_tpu/decode/device_windows.py: greedy mode with or without
the decode-step kernel K2, beam mode with or without the beam-step kernel
K7, and speculative mode; any of them over an int8 cross-KV, `quant_kv`).

Each window runs on the device: encoder + cross-KV, the prompt build from
the right-aligned rolling context, the segment decode (greedy:
device_loop.segment_core; beam: device_beam.decode_segment_beam followed
by whisper_rank over the beams -- the entropy gate, the length penalty and
the best score -- on the device; speculative: the draft model's encoder
pass over its own mel of the same window, then device_speculative.
speculative_core), the quality gates (avg-logprob /
entropy / no-speech, whisper.cpp:7545-7605), the rolling-context update
(whisper.cpp:7625-7636) and the seek advance. The host reads one small
control pair per window (fallback flag, next seek) to decide whether to go
on, besides the segment loop's done-flag polls, and the caller reads the
packed result once per call. A window that trips a quality gate stops the
loop; the host re-decodes it with the temperature-fallback schedule
(decode/full.py).

One deliberate difference from the JAX loop: a window whose only failure
is the entropy gate reports its true `result_len`, as
decode/full.py::_rank_decoders (and whisper.cpp) do, where the JAX loop
reports the full sampled length (in beam mode: the best beam's). It shows
only when no fallback is available (temperature_inc = 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.whisper import model as M
from ..ops.decode_megakernel import MegaParams
from . import logit_rules as LR
from .device_beam import decode_segment_beam
from .device_loop import CHUNK_FRAMES, HostReads, SegmentResult, segment_core
from .device_speculative import speculative_core

DELTA_MIN = 10  # 100 ms in 10 ms frames


@dataclasses.dataclass
class WindowsResult:
    # per-window buffers, leading axis K
    tokens: torch.Tensor      # (K, n_max) long
    p: torch.Tensor           # (K, n_max) f32
    plog: torch.Tensor
    pt: torch.Tensor
    ptsum: torch.Tensor
    tid: torch.Tensor         # (K, n_max) long
    n_tokens: torch.Tensor    # (K,) sampled count
    result_len: torch.Tensor  # (K,)
    seek: torch.Tensor        # (K,) window start frame
    seek_delta: torch.Tensor  # (K,) applied advance (post single-ts-end)
    no_speech_prob: torch.Tensor  # (K,) f32
    avg_logprobs: torch.Tensor    # (K,) f32
    is_no_speech: torch.Tensor    # (K,) bool: skip emission + past update
    # call-level state
    n_done: int               # windows fully decoded this call
    fallback: bool            # window n_done needs host re-decode
    next_seek: int            # seek after the last decoded window
    past_buf: torch.Tensor    # (P,) long right-aligned rolling context
    past_len: torch.Tensor    # 0-d long
    n_rounds: torch.Tensor    # 0-d long: speculative verify passes (0 otherwise)
    n_accepted: torch.Tensor  # 0-d long: accepted draft tokens


@dataclasses.dataclass
class Draft:
    """The draft model of speculative mode: its config, encoder and decoder
    params, whole-audio mel (its own filters), the lookahead gamma, and the
    kernel K2's params for the draft steps (`dmega`) and the verify pass
    (`tmega`, the target's), each or None."""
    cfg: M.WhisperConfig
    enc_params: M.Params
    dec_params: M.Params
    mel_data: torch.Tensor
    gamma: int
    dmega: MegaParams | None = None
    tmega: MegaParams | None = None


def _entropy_last32(tokens: torch.Tensor, result_len: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the token multiset over tokens[max(0,rl-32):rl]
    (whisper_sequence_score, src/whisper.cpp:6622-6641), as
    H = -(1/n) * sum_i log(c_i / n) over the n valid positions."""
    dev = tokens.device
    lo = torch.clamp(result_len - 32, min=0)
    idx = lo + torch.arange(32, device=dev)
    valid = idx < result_len
    toks = tokens[torch.clamp(idx, 0, tokens.shape[0] - 1)]
    eq = (toks[:, None] == toks[None, :]) & valid[:, None] & valid[None, :]
    c = eq.sum(dim=1)
    n = torch.clamp(result_len - lo, min=1).float()
    logp = torch.log(torch.clamp(c, min=1).float() / n)
    return -torch.where(valid, logp, 0.0).sum() / n


def _rank_beams(bres, ent_thold: float, length_penalty: float, ar_n: torch.Tensor):
    """whisper_rank on the device (_rank_decoders / _score_sequence,
    whisper.cpp:7545-7605): each beam's score over its result_len tokens
    with the length penalty, the entropy gate, the best beam (the first of
    equal scores; beam 0 when every beam failed). Returns the best beam's
    segment fields as a SegmentResult (`failed` the loop's own verdict, as
    _rank_decoders keeps it) and its full length n_valid."""
    B = bres.tokens.shape[0]
    rl_b = bres.result_len
    total_lp = torch.where(ar_n[None, :] < rl_b[:, None], bres.plog, 0.0).sum(dim=1)
    ent = torch.stack([_entropy_last32(bres.tokens[j], rl_b[j]) for j in range(B)])
    failed = bres.failed | ((rl_b > 32) & (ent < ent_thold))
    rlf = rl_b.float()
    pen = ((5.0 + rlf) / 6.0) ** length_penalty if length_penalty > 0 else rlf
    score = torch.where(failed | (rl_b == 0), float("-inf"),
                        total_lp / torch.clamp(pen, min=1e-6))
    best = torch.argmax(score).reshape(1)
    # index_select: indexing with a 0-d tensor would read it to the host
    pick = lambda a: a.index_select(0, best)[0]                 # noqa: E731
    seg = SegmentResult(
        tokens=pick(bres.tokens), p=pick(bres.p), plog=pick(bres.plog),
        pt=pick(bres.pt), ptsum=pick(bres.ptsum), tid=pick(bres.tid),
        n_tokens=bres.n_tokens, result_len=pick(rl_b),
        seek_delta=pick(bres.seek_delta), has_ts=pick(bres.has_ts),
        completed=pick(bres.completed), failed=pick(bres.failed),
        sum_logprobs_all=pick(bres.sum_lp), no_speech_prob=bres.no_speech_prob)
    return seg, pick(bres.n_valid)


def _roll(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """jnp.roll along axis 0 by a device-side amount."""
    n = x.shape[0]
    idx = (torch.arange(n, device=x.device) - shift) % n
    return x[idx]


def decode_windows(cfg: M.WhisperConfig, rc: LR.RuleConfig,
                   enc_params: M.Params, dec_params: M.Params,
                   mel_data: torch.Tensor,
                   base_mask: torch.Tensor, init_mask: torch.Tensor,
                   past_buf: torch.Tensor, iscalars, fscalars, *,
                   prompt_init: tuple[int, ...], K: int, n_max: int, P: int,
                   reads: HostReads, max_tokens: int = 0,
                   no_timestamps: bool = False, stub: bool = False,
                   window_frames: int = 2 * 1500,
                   fallback_available: bool = True,
                   mega: MegaParams | None = None,
                   beam_size: int = 0, draft: Draft | None = None,
                   quant_kv: bool = False) -> WindowsResult:
    """Decode up to K windows, greedily, by beam search (beam_size > 1) or
    speculatively (`draft`: each window's draft encoder pass and
    speculative_core; the result's n_rounds and n_accepted count its verify
    passes and accepted draft tokens).

    mel_data (n_pad, n_mels) whole-audio mel on the device, zero past n_len;
    past_buf (P,) right-aligned rolling prompt context on the device.
    iscalars ints: [token_nosp, token_prev, seek, seek_start, seek_end,
    past_len]. fscalars floats: [logprob_thold, entropy_thold,
    no_speech_thold] (+ length_penalty in beam mode). `mega`: token steps
    run kernel K2 (greedy, device_loop.segment_core) or K7 (beam,
    device_beam.decode_segment_beam, cross-KV shared by the beams).
    `quant_kv`: each window's cross-KV is quantized to int8 QuantKV planes
    after its encoder pass (the one-row decoder steps run kernel K9b; the
    draft's cross-KV stays float), the JAX loop's `quant_kv`."""
    dev = mel_data.device
    token_nosp, token_prev, seek0, seek_start, seek_end, past_len0 = (
        int(x) for x in iscalars[:6])
    lp_thold, ent_thold, nsp_thold = (float(x) for x in fscalars[:3])
    n_init = len(prompt_init)
    T_pad = 1 + P + n_init          # token_prev + past tail + task prompt
    init_arr = torch.tensor(prompt_init, dtype=torch.long, device=dev)
    cache_dtype = enc_params["conv1_w"].dtype
    kv_k, kv_v = M.init_kv_cache(cfg, 1, dtype=cache_dtype, device=dev)

    zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    zl = lambda *s: torch.zeros(s, dtype=torch.long, device=dev)
    out = WindowsResult(
        tokens=zl(K, n_max), p=zf(K, n_max), plog=zf(K, n_max),
        pt=zf(K, n_max), ptsum=zf(K, n_max), tid=zl(K, n_max),
        n_tokens=zl(K), result_len=zl(K), seek=zl(K), seek_delta=zl(K),
        no_speech_prob=zf(K), avg_logprobs=zf(K),
        is_no_speech=torch.zeros(K, dtype=torch.bool, device=dev),
        n_done=0, fallback=False, next_seek=seek0,
        past_buf=past_buf, past_len=torch.tensor(past_len0, device=dev),
        n_rounds=zl(), n_accepted=zl())

    seek = seek0
    past_len = out.past_len
    ar_p = torch.arange(P, device=dev)
    ar_n = torch.arange(n_max, device=dev)
    w = 0
    while w < K and seek + DELTA_MIN < seek_end:
        # drop confusing history near the very end (whisper.cpp:7060-7064)
        if seek > seek_start and seek + 500 >= seek_end:
            past_len = torch.zeros_like(past_len)

        # ---- encode this window (whisper_encode_internal) ----
        i0 = min(seek, mel_data.shape[0] - window_frames)  # jax dynamic_slice clamp
        window = mel_data[i0:i0 + window_frames]
        _eo, xk, xv = M.encode_with_cross_kv(cfg, enc_params, dec_params,
                                             window[None])
        if quant_kv:
            xk = M.quantize_cross_kv(xk, cfg.n_text_head)
            xv = M.quantize_cross_kv(xv, cfg.n_text_head)

        # ---- build the prompt (whisper.cpp:7121-7148) ----
        if P > 0:
            use_past = past_len > 0
            # prompt = [token_prev] + past_buf tail + prompt_init, left-aligned
            i = torch.arange(T_pad, device=dev)
            t_real = torch.where(use_past, 1 + past_len + n_init, n_init)
            off = use_past.long()                    # position of past start
            past_idx = P - past_len + (i - off)      # right-aligned past gather
            from_past = use_past & (i >= off) & (i < off + past_len)
            init_pos = i - (off + torch.where(use_past, past_len, 0))
            from_init = (init_pos >= 0) & (init_pos < n_init)
            prompt = torch.where(
                use_past & (i == 0), token_prev,
                torch.where(from_past, past_buf[torch.clamp(past_idx, 0, P - 1)],
                            torch.where(from_init,
                                        init_arr[torch.clamp(init_pos, 0, n_init - 1)],
                                        0)))
        else:  # context carry disabled (n_max_text_ctx <= 1)
            t_real = torch.tensor(n_init, dtype=torch.long, device=dev)
            prompt = torch.cat([init_arr, zl(T_pad - n_init)])

        # ---- segment decode ----
        n_rounds_w = n_acc_w = None
        if draft is not None:
            dwindow = draft.mel_data[i0:i0 + window_frames]
            _deo, dxk, dxv = M.encode_with_cross_kv(draft.cfg, draft.enc_params,
                                                    draft.dec_params, dwindow[None])
            seg, n_acc_w, n_rounds_w = speculative_core(
                cfg, draft.cfg, rc, dec_params, draft.dec_params, prompt[None], xk, xv,
                dxk, dxv, base_mask, init_mask, t_real, token_nosp, seek, seek_end,
                n_max=n_max, reads=reads, gamma=draft.gamma, max_tokens=max_tokens,
                single_segment=False, no_timestamps=no_timestamps,
                cache_dtype=cache_dtype, dmega=draft.dmega, tmega=draft.tmega)
            full_len = seg.n_tokens
        elif beam_size > 1:
            bres = decode_segment_beam(
                cfg, rc, dec_params, prompt[None], xk, xv, base_mask, init_mask,
                (t_real, token_nosp, seek, seek_end), beam_size=beam_size,
                n_max=n_max, reads=reads, max_tokens=max_tokens,
                single_segment=False, no_timestamps=no_timestamps, stub=stub,
                mega=mega, cache_dtype=cache_dtype)
            seg, full_len = _rank_beams(bres, ent_thold, float(fscalars[3]), ar_n)
        else:
            seg = segment_core(
                cfg, rc, dec_params, prompt[None], kv_k, kv_v, xk, xv,
                base_mask, init_mask, t_real, token_nosp, seek, seek_end,
                n_max=n_max, reads=reads, max_tokens=max_tokens,
                single_segment=False, no_timestamps=no_timestamps, stub=stub,
                mega=mega)
            full_len = seg.n_tokens
        nsp = seg.no_speech_prob

        # ---- quality gates (whisper_rank / _score_sequence) ----
        rl = seg.result_len
        total_lp = torch.where(ar_n < rl, seg.plog, 0.0).sum()
        avg_lp = torch.where(rl > 0, total_lp / torch.clamp(rl, min=1), float("-inf"))
        entropy = _entropy_last32(seg.tokens, rl)
        failed = seg.failed | ((rl > 32) & (entropy < ent_thold))
        low_conf = (avg_lp < lp_thold) & (nsp < nsp_thold)
        needs_fallback = (failed | low_conf) & fallback_available
        is_nsp = (nsp > nsp_thold) & (avg_lp < lp_thold)

        # single-timestamp ending skips the whole chunk (whisper.cpp:7758)
        tb = rc.token_beg
        # index_select: indexing with a 0-d tensor would read it to the host
        tl, tp = seg.tokens.index_select(
            0, torch.clamp(torch.stack([rl - 1, rl - 2]), 0, n_max - 1))
        single_ts_end = (rl > 1) & (tp < tb) & (tl > tb)
        seek_delta = torch.where(single_ts_end,
                                 min(seek_end - seek, CHUNK_FRAMES), seg.seek_delta)

        # one read per window: go on, or hand this window to the host
        fb, seek_delta_h = (int(x) for x in reads.fetch(
            torch.stack([needs_fallback.long(), seek_delta])))
        if fb:
            out.fallback = True
            break

        # ---- rolling context update (whisper.cpp:7625-7636) ----
        # new past = (past tail used this window) + tokens[:result_len],
        # truncated to the last P entries; a no-speech window keeps the
        # used tail but adds nothing (whisper.cpp:7631)
        take = torch.where(is_nsp, 0, rl)
        used = torch.where(ar_p >= P - past_len, past_buf, 0)
        toks_z = torch.where(ar_n < take, seg.tokens, 0)
        full = (_roll(torch.cat([used, zl(n_max)]), n_max - take)
                + torch.cat([zl(P), _roll(toks_z, n_max - take)]))
        past_buf = full[n_max:]
        past_len = torch.clamp(past_len + take, max=P)

        # ---- write outputs at row w ----
        # entropy-only failures keep their true result_len (_rank_decoders);
        # a failed decoder emits its full sampled sequence
        for name in ("tokens", "p", "plog", "pt", "ptsum", "tid"):
            getattr(out, name)[w] = getattr(seg, name)
        out.n_tokens[w] = seg.n_tokens
        out.result_len[w] = torch.where(seg.failed, full_len, rl)
        out.seek[w] = seek
        out.seek_delta[w] = seek_delta_h
        out.no_speech_prob[w] = nsp
        out.avg_logprobs[w] = avg_lp
        out.is_no_speech[w] = is_nsp
        if n_rounds_w is not None:
            out.n_rounds += n_rounds_w
            out.n_accepted += n_acc_w
        seek += seek_delta_h
        w += 1

    out.n_done, out.next_seek = w, seek
    out.past_buf, out.past_len = past_buf, past_len
    return out


def pack_windows_result(res: WindowsResult) -> torch.Tensor:
    """Flatten the device buffers to ONE f32 tensor: one device->host read
    per call (n_done, fallback and next_seek are already host values)."""
    mats = torch.cat([res.tokens.float(), res.p, res.plog, res.pt, res.ptsum,
                      res.tid.float()], dim=1).reshape(-1)
    per_w = torch.stack([
        res.n_tokens.float(), res.result_len.float(), res.seek.float(),
        res.seek_delta.float(), res.no_speech_prob, res.avg_logprobs,
        res.is_no_speech.float()]).reshape(-1)
    return torch.cat([mats, per_w, torch.stack([res.past_len, res.n_rounds,
                                                res.n_accepted]).float()])


def unpack_windows_result(flat: np.ndarray, res: WindowsResult, K: int,
                          n_max: int) -> dict:
    flat = np.asarray(flat)
    mats = flat[:K * 6 * n_max].reshape(K, 6 * n_max)
    f = lambda i: mats[:, i * n_max:(i + 1) * n_max]
    pw = flat[K * 6 * n_max:K * 6 * n_max + 7 * K].reshape(7, K)
    return dict(
        tokens=f(0).astype(np.int64), p=f(1), plog=f(2), pt=f(3), ptsum=f(4),
        tid=f(5).astype(np.int64),
        n_tokens=pw[0].astype(np.int64), result_len=pw[1].astype(np.int64),
        seek=pw[2].astype(np.int64), seek_delta=pw[3].astype(np.int64),
        no_speech_prob=pw[4], avg_logprobs=pw[5],
        is_no_speech=pw[6].astype(bool),
        n_done=res.n_done, fallback=res.fallback, next_seek=res.next_seek,
        past_len=int(flat[-3]), n_rounds=int(flat[-2]), n_accepted=int(flat[-1]))
