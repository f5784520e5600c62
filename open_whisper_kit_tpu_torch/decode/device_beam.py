"""On-device beam-search segment decoder (port of
open_whisper_kit_tpu/decode/device_beam.py).

The counterpart of the reference's beam loop (whisper.cpp:7301-7352 merge,
:7355-7459 state machine): every token step expands each live beam into
`beam_size` top-k candidates, sorts the pool by (sum of logprobs desc,
source beam asc), assigns the winners to the live beam slots skipping
duplicate sequences, and follows each slot's source beam. All of it runs as
tensor ops on the prompt's device. The host issues the steps without
waiting and reads the loop's done flag only once every `POLL` steps; steps
issued after every beam ended change no recorded output, and their cache
position is clamped inside n_text_ctx.

Duplicates are found by two uint32 rolling hashes of each beam's token
sequence (h * 1000003 + tok and h * 0x9E3779B1 + tok, mod 2^32, kept in
int64), as in the JAX package, where the host merge
(decode/full.py::_beam_expand_and_merge) compares the sequences token by
token. The JAX package's sequential assignment scan becomes one vectorized
pass: a candidate is taken when its score is finite, no earlier candidate
has the same hashes (from the second step on), and fewer earlier
candidates than live beams were kept.

With `mega` (MegaParams) the prompt is ingested once at batch 1 through
`decode_impl`, the cache becomes row-flat and time-major (L, n_ctx * B, S)
with slot 0 holding the prompt, and every token step is one call of the
beam-step kernel K7 (ops/decode_megakernel.py::mega_decode_step_beam):
the caches never move, the lineage lives in an origin table that the
kernel reads (the JAX package turns it into an attention bias with
`beam_attn_bias`), and the cross-KV is shared. Without `mega`,
`decode_impl` runs the B beams with a physical cache reorder
(`reorder_kv`) each step, every beam reading the batch-1 cross-KV.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.whisper import model as M
from ..ops import decode_megakernel as MK
from . import logit_rules as LR
from .device_loop import CHUNK_FRAMES, POLL, HostReads

DELTA_MIN = 10
_H1, _H2 = 1000003, 0x9E3779B1
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h * c mod 2^32 for uint32 values kept in int64 (no product of two
    32-bit numbers, which int64 cannot hold)."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def rolling_hash(h: torch.Tensor, tok: torch.Tensor, c: int) -> torch.Tensor:
    """The uint32 sequence hash h * c + tok (mod 2^32) of the JAX package."""
    return (_mul32(h, c) + tok) & _MASK32


@dataclasses.dataclass
class BeamSegmentResult:
    tokens: torch.Tensor      # (B, n_max) long
    p: torch.Tensor           # (B, n_max) f32
    plog: torch.Tensor
    pt: torch.Tensor
    ptsum: torch.Tensor
    tid: torch.Tensor         # (B, n_max) long
    n_tokens: torch.Tensor    # 0-d: steps taken while a beam was live
    sum_lp: torch.Tensor      # (B,) sum of every appended token's logprob
    result_len: torch.Tensor  # (B,)
    n_valid: torch.Tensor     # (B,) tokens appended before the beam ended
                              # (a failed beam emits all of them,
                              # whisper.cpp:7556 and :7615)
    seek_delta: torch.Tensor
    has_ts: torch.Tensor
    completed: torch.Tensor
    failed: torch.Tensor
    no_speech_prob: torch.Tensor


def decode_segment_beam(cfg: M.WhisperConfig, rc: LR.RuleConfig,
                        dec: M.Params, prompt: torch.Tensor,
                        xk: torch.Tensor, xv: torch.Tensor,
                        base_mask: torch.Tensor, init_mask: torch.Tensor,
                        scalars, *, beam_size: int, n_max: int,
                        reads: HostReads, max_tokens: int = 0,
                        single_segment: bool = False,
                        no_timestamps: bool = False, stub: bool = False,
                        mega: MK.MegaParams | None = None,
                        cache_dtype: torch.dtype = torch.bfloat16
                        ) -> BeamSegmentResult:
    """Beam-search one window on the prompt's device. prompt (1, T_pad)
    long; xk/xv (L, 1, Ta, S) cross-KV or batch-1 QuantKV planes, shared by
    the beams (`mega` reads the float cross-KV only); `scalars` =
    (t_real, token_nosp, seek, seek_end): t_real and seek ints or 0-d
    tensors (the window loop keeps t_real on the device). The self-KV
    caches are allocated here. The loop runs at most n_max steps and stops
    at the first `reads.flag` poll (every POLL steps) after every beam
    ended."""
    t_real, token_nosp, seek, seek_end = scalars
    B = beam_size
    dev = prompt.device
    token_beg, token_eot = rc.token_beg, rc.token_eot
    L, S, n_ctx = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx
    t_real = torch.as_tensor(t_real, device=dev).long()
    ar_b = torch.arange(B, device=dev)

    # ---- prompt ingest (logits only at the last real position) ----
    if mega is not None:
        # the origin table lets every beam attend slot 0's prompt rows, so
        # the prompt is ingested once (batch 1); slots 1..B-1 start empty
        k1, v1 = M.init_kv_cache(cfg, 1, dtype=cache_dtype, device=dev)
        logits1, k1, v1 = M.decode_impl(cfg, dec, prompt, k1, v1, 0, xk, xv,
                                        logits_pos=t_real - 1)

        def time_major(a):    # (L, 1, n_ctx, S) -> flat (L, n_ctx * B, S)
            tm = torch.zeros(L, n_ctx, B, S, dtype=a.dtype, device=dev)
            tm[:, :, 0] = a[:, 0]
            return tm.reshape(L, n_ctx * B, S)
        kv_k, kv_v = time_major(k1), time_major(v1)
        origin = torch.where(torch.arange(n_ctx, device=dev)[None, :] < t_real,
                             0, ar_b[:, None])                      # (B, n_ctx)
        logits = logits1[:, 0].expand(B, -1)
        xk_nat, xv_nat = xk[:, 0], xv[:, 0]                          # (L, Ta, S)
    else:
        kv_k, kv_v = M.init_kv_cache(cfg, B, dtype=cache_dtype, device=dev)
        logits_all, kv_k, kv_v = M.decode_impl(
            cfg, dec, prompt.expand(B, -1), kv_k, kv_v, 0, xk, xv,
            logits_pos=t_real - 1)
        logits = logits_all[:, 0]                                    # (B, V)
    no_speech_prob = LR.compute_no_speech_prob(logits[0], token_nosp)

    zf = lambda: torch.zeros(B, n_max, dtype=torch.float32, device=dev)  # noqa: E731
    zl = lambda *s: torch.zeros(s, dtype=torch.long, device=dev)          # noqa: E731
    zb = lambda: torch.zeros(B, dtype=torch.bool, device=dev)             # noqa: E731
    tokens, tid_buf = zl(B, n_max), zl(B, n_max)
    p_buf, plog_buf, pt_buf, ptsum_buf = zf(), zf(), zf(), zf()
    h1, h2 = zl(B), zl(B)
    sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
    last_was_ts, penult_was_ts, has_ts = zb(), ~zb(), zb()
    seek_delta = torch.full((B,), CHUNK_FRAMES, dtype=torch.long, device=dev)
    result_len, n_valid = zl(B), zl(B)
    completed, failed = zb(), zb()
    n_tok = zl()
    initial = (~zb(), zb())
    src_of = torch.arange(B * B, device=dev) // B              # candidate -> source
    earlier = torch.ones(B * B, B * B, dtype=torch.bool, device=dev).tril(-1)
    ts_zero = zl(B)

    for i in range(n_max):
        if i and i % POLL == 0 and reads.flag(~(~completed & ~failed).any()):
            break
        active = ~completed & ~failed                            # (B,)
        n_tok = n_tok + active.any().long()
        st = LR.BeamState(
            is_initial=initial[0] if i == 0 else initial[1],
            last_was_ts=last_was_ts, penult_was_ts=penult_was_ts, has_ts=has_ts,
            ts_min=torch.where(has_ts, token_beg + seek_delta // 2, ts_zero))
        f_logits, f_logprobs, f_probs = LR.apply_rules(
            rc, logits, base_mask, init_mask, st, 0.0)
        top_id, top_p, top_lp, pt_b, pts_b, tid_b = LR.sample_topk(
            rc, B, f_logits, f_logprobs, f_probs)                 # (B, B) each

        # ---- the candidate pool, sorted by (score desc, source asc) ----
        # the pool is source-major, so a stable sort on the score alone
        # keeps the source order among equal scores
        score = torch.where(active[src_of], (sum_lp[:, None] + top_lp).reshape(-1),
                            float("-inf"))
        score, order = torch.sort(score, descending=True, stable=True)
        srcs = src_of[order]
        ids = top_id.reshape(-1)[order]
        lps = top_lp.reshape(-1)[order]
        ps = top_p.reshape(-1)[order]
        sig1 = rolling_hash(h1[srcs], ids, _H1)
        sig2 = rolling_hash(h2[srcs], ids, _H2)

        # ---- assignment with dedupe (whisper.cpp:7322-7341) ----
        keep = torch.isfinite(score)
        if i > 0:
            same = (sig1[:, None] == sig1[None, :]) & (sig2[:, None] == sig2[None, :])
            keep = keep & ~(same & earlier).any(dim=1)
        slot = torch.cumsum(keep.long(), 0) - 1
        take = keep & (slot < active.sum())
        # slot s -> the s-th live beam; a beam no candidate lands on keeps itself
        beam_of_slot = torch.sort((~active).long(), stable=True).indices
        target = torch.where(take, beam_of_slot[slot.clamp(0, B - 1)], B)

        def scatter(init, vals):
            out = torch.cat([init, init[:1]])    # row B takes what is not taken
            out[target] = vals
            return out[:B]
        new_src = scatter(ar_b, srcs)
        new_tok = scatter(torch.zeros_like(ar_b), ids)
        new_lp = scatter(torch.zeros_like(sum_lp), lps)
        new_p = scatter(torch.zeros_like(sum_lp), ps)

        # ---- every slot follows its source beam ----
        g = lambda x: x[new_src]                                  # noqa: E731
        tokens, p_buf, plog_buf = g(tokens), g(p_buf), g(plog_buf)
        pt_buf, ptsum_buf, tid_buf = g(pt_buf), g(ptsum_buf), g(tid_buf)
        sum_lp, last_was, has_ts = g(sum_lp), g(last_was_ts), g(has_ts)
        seek_delta, result_len, h1, h2 = g(seek_delta), g(result_len), g(h1), g(h2)
        is_ts_tok = new_tok >= token_beg
        tid_new = torch.where(is_ts_tok, new_tok, g(tid_b))
        pt_new = torch.where(is_ts_tok, new_p, g(pt_b))

        # append the new token on the live beams
        wr = active
        tokens[:, i] = torch.where(wr, new_tok, tokens[:, i])
        p_buf[:, i] = torch.where(wr, new_p, p_buf[:, i])
        plog_buf[:, i] = torch.where(wr, new_lp, plog_buf[:, i])
        pt_buf[:, i] = torch.where(wr, pt_new, pt_buf[:, i])
        ptsum_buf[:, i] = torch.where(wr, g(pts_b), ptsum_buf[:, i])
        tid_buf[:, i] = torch.where(wr, tid_new, tid_buf[:, i])
        sum_lp = torch.where(wr, sum_lp + new_lp, sum_lp)
        n_valid = torch.where(wr, i + 1, g(n_valid))
        h1 = torch.where(wr, rolling_hash(h1, new_tok, _H1), h1)
        h2 = torch.where(wr, rolling_hash(h2, new_tok, _H2), h2)

        # ---- state machine (whisper.cpp:7355-7459) ----
        gt_beg = (new_tok > token_beg) & wr
        sd_new = 2 * (new_tok - token_beg)
        ts_fail = gt_beg & has_ts & (seek_delta > sd_new) & (result_len < i)
        take_ts = gt_beg & ~ts_fail
        seek_delta = torch.where(take_ts, sd_new, seek_delta)
        result_len = torch.where(take_ts, i + 1, result_len)
        has_ts = has_ts | take_ts
        at_end = seek + seek_delta + DELTA_MIN >= seek_end
        end_hit = wr & ~ts_fail & (
            (new_tok == token_eot) | bool(max_tokens > 0 and i >= max_tokens)
            | (has_ts & at_end))
        rl_zero = (result_len == 0) & (not no_timestamps)
        end_fail = end_hit & rl_zero & ~at_end
        result_len = torch.where(end_hit & rl_zero & at_end, i + 1, result_len)
        end_ok = end_hit & ~end_fail
        if single_segment or no_timestamps:
            result_len = torch.where(end_ok, i + 1, result_len)
            seek_delta = torch.where(end_ok, CHUNK_FRAMES, seek_delta)
        completed = completed | end_ok
        failed = failed | ts_fail | end_fail
        if stub:   # weightless test checkpoints (whisper.cpp:7426-7431)
            newly = wr & ~completed & ~failed
            seek_delta = torch.where(newly, CHUNK_FRAMES, seek_delta)
            completed = completed | newly
        if i == n_max - 1:   # repetition-loop bail-out (whisper.cpp:7440-7445)
            failed = failed | (wr & ~completed & ~failed & (
                (result_len == 0) | (seek_delta < CHUNK_FRAMES // 2)))
        penult_was_ts = torch.where(wr, last_was | (i == 0), g(penult_was_ts))
        last_was_ts = torch.where(wr, is_ts_tok, last_was)

        # ---- next decode step, all beams (unused after the last live step) ----
        if i + 1 < n_max:
            pos = torch.clamp(t_real + i, max=n_ctx - 1).reshape(1)
            if mega is not None:
                # no cache movement: inherit the sources' lineage, and each
                # slot owns its row at this step's position
                origin = g(origin)
                origin.index_copy_(1, pos, ar_b[:, None])
                x0 = (dec["te"][new_tok] + dec["pe"].index_select(0, pos)
                      ).to(torch.bfloat16)
                logits, kv_k, kv_v = MK.mega_decode_step_beam(
                    cfg, mega, x0, kv_k, kv_v, pos[0], xk_nat, xv_nat, origin=origin)
            else:
                kv_k, kv_v = M.reorder_kv(kv_k, kv_v, new_src)
                step_logits, kv_k, kv_v = M.decode_impl(
                    cfg, dec, new_tok[:, None], kv_k, kv_v, pos[0], xk, xv)
                logits = step_logits[:, 0]

    return BeamSegmentResult(
        tokens=tokens, p=p_buf, plog=plog_buf, pt=pt_buf, ptsum=ptsum_buf,
        tid=tid_buf, n_tokens=n_tok, sum_lp=sum_lp, result_len=result_len,
        n_valid=n_valid, seek_delta=seek_delta, has_ts=has_ts,
        completed=completed, failed=failed, no_speech_prob=no_speech_prob)


def pack_beam_result(res: BeamSegmentResult) -> torch.Tensor:
    """Flatten the result into ONE f32 tensor so the host pays a single
    device->host read (every value is exactly representable); the JAX
    package's layout."""
    f = lambda x: x.float().reshape(-1)                          # noqa: E731
    per_beam = torch.stack([f(res.sum_lp), f(res.result_len), f(res.seek_delta),
                            f(res.has_ts), f(res.completed), f(res.failed),
                            f(res.n_valid)])                      # (7, B)
    return torch.cat([f(res.tokens), f(res.p), f(res.plog), f(res.pt), f(res.ptsum),
                      f(res.tid), per_beam.reshape(-1), f(res.n_tokens),
                      f(res.no_speech_prob)])


def unpack_beam_result(flat: np.ndarray, beam_size: int, n_max: int) -> list[dict]:
    """Inverse of pack_beam_result -> one dict per beam, keyed as the greedy
    loop's (device_loop.unpack_segment_result), with the beam's n_valid;
    n_tokens and no_speech_prob are the window's, the same in each."""
    flat = np.asarray(flat)
    n = beam_size * n_max
    f = lambda i: flat[i * n:(i + 1) * n].reshape(beam_size, n_max)  # noqa: E731
    pb = flat[6 * n:6 * n + 7 * beam_size].reshape(7, beam_size)
    tail = flat[6 * n + 7 * beam_size:]
    tokens, tid = f(0).astype(np.int64), f(5).astype(np.int64)
    return [dict(tokens=tokens[b], p=f(1)[b], plog=f(2)[b], pt=f(3)[b], ptsum=f(4)[b],
                 tid=tid[b], n_tokens=int(tail[0]), result_len=int(pb[1, b]),
                 seek_delta=int(pb[2, b]), has_ts=bool(pb[3, b] > 0.5),
                 completed=bool(pb[4, b] > 0.5), failed=bool(pb[5, b] > 0.5),
                 sum_logprobs_all=float(pb[0, b]), n_valid=int(pb[6, b]),
                 no_speech_prob=float(tail[1]))
            for b in range(beam_size)]
