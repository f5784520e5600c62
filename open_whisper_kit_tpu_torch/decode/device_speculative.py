"""Speculative greedy segment decoder: a draft model proposes, the target
verifies (port of open_whisper_kit_tpu/decode/device_speculative.py).

A small DRAFT model proposes `gamma` tokens with cheap one-token steps,
and the TARGET model scores all of them in ONE (gamma + 1)-token decoder
pass. Every emitted token is the target's own rule-filtered argmax,
conditioned on the accepted prefix, so the transcript equals the greedy
loop's (decode/device_loop.py); the draft only decides how many positions
each target pass covers. The per-token state machine is the greedy loop's
(device_loop.machine_step).

Round invariant: both KV caches hold every emitted token except the newest
(`last_tok`), which each round ingests as the first token of its verify
pass and of its draft scan. A round that accepted m draft tokens emits
m + 1 (the correction on a mismatch, or the verify pass's last row on full
acceptance), and both models' `kv_head` advance by that count.

As in the greedy loop, everything runs on the context's device: `kv_head`,
the token index `i` and `last_tok` are device tensors, buffer writes are
masked on the device (writes past n_max are dropped), and the host issues
the rounds without waiting. It reads the loop's done flag once every
`POLL` rounds; rounds issued after the segment ended are masked and change
no output. The caller reads one packed result per window.

With `dmega` (MegaParams) the draft's steps run kernel K2 at one row, else
`decode_impl`; with `tmega` the verify pass runs K2 at R = gamma + 1 rows
(gamma + 1 <= 8; each row bit-identical to the one-row step, so a K2
verify equals K2 greedy exactly), else `decode_impl` at T = gamma + 1.
Prompt ingest runs `decode_impl` for both models.
"""

from __future__ import annotations

import torch

from ..models.whisper import model as M
from ..ops import decode_megakernel as MK
from . import logit_rules as LR
from .device_loop import HostReads, SegmentResult, machine_init, machine_step

POLL = 4   # rounds between host reads of the loop's done flag


def cache_rows(cfg: M.WhisperConfig, gamma: int) -> int:
    """Self-cache rows of a model in the speculative loop: n_text_ctx +
    gamma + 4 (a verify pass may write gamma + 1 rows past the last token)."""
    return cfg.n_text_ctx + gamma + 4


def _rule_state(ms, token_beg: int, is_initial: torch.Tensor) -> LR.BeamState:
    return LR.BeamState(
        is_initial=is_initial, last_was_ts=ms.last_was_ts[None],
        penult_was_ts=ms.penult_was_ts[None], has_ts=ms.has_ts[None],
        ts_min=torch.where(ms.has_ts, token_beg + ms.seek_delta // 2, 0)[None])


def _choose(rc, row: torch.Tensor, base_mask, init_mask, st):
    """Greedy pick from one (1, V) raw-logits row under the full rule set;
    (tok, p, plog, pt, ptsum, tid), each of shape (1,)."""
    f_logits, f_logprobs, f_probs = LR.apply_rules(rc, row, base_mask, init_mask, st, 0.0)
    return LR.sample_greedy(rc, f_logits, f_logprobs, f_probs)


def _embed(dec, toks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K2's (R, S) bf16 input rows: token plus position embedding. Positions
    past the table take its last row, as JAX's gather clamps; index_select
    keeps the device tensors on the device."""
    pe = dec["pe"]
    return (dec["te"].index_select(0, toks)
            + pe.index_select(0, pos.clamp(max=pe.shape[0] - 1))).to(torch.bfloat16)


def speculative_core(cfg: M.WhisperConfig, dcfg: M.WhisperConfig, rc: LR.RuleConfig,
                     dec: M.Params, ddec: M.Params, prompt: torch.Tensor,
                     xk: torch.Tensor, xv: torch.Tensor, dxk: torch.Tensor,
                     dxv: torch.Tensor, base_mask: torch.Tensor, init_mask: torch.Tensor,
                     t_real: torch.Tensor, token_nosp: int, seek, seek_end: int, *,
                     n_max: int, reads: HostReads, gamma: int = 4, max_tokens: int = 0,
                     single_segment: bool = False, no_timestamps: bool = False,
                     cache_dtype: torch.dtype = torch.bfloat16,
                     dmega: MK.MegaParams | None = None, tmega: MK.MegaParams | None = None
                     ) -> tuple[SegmentResult, torch.Tensor, torch.Tensor]:
    """Speculative greedy decode of one window on the prompt's device;
    shared by `decode_segment_speculative` and the K-windows loop in
    decode/device_windows.py.

    dec/ddec are the target's and the draft's prepared decoders, xk/xv and
    dxk/dxv their (L, 1, Ta, S) cross-KV for this window (the target's may
    be QuantKV planes; `tmega` reads the float cross-KV only); prompt (1, T_pad)
    long; `t_real` a 0-d long tensor; `seek` an int or a 0-d tensor. Both
    models' self-caches are allocated here, `cache_rows` each. Returns
    (SegmentResult, n_accepted, n_rounds): accepted draft tokens and verify
    passes, 0-d device tensors."""
    if tmega is not None and gamma + 1 > 8:
        raise ValueError(f"tmega: a verify pass of {gamma + 1} rows; K2 takes 8 at most")
    token_beg = rc.token_beg
    dev = prompt.device

    def step(ms, tok, i):
        return machine_step(ms, tok, i, token_beg=token_beg, token_eot=rc.token_eot,
                            seek=seek, seek_end=seek_end, n_max=n_max,
                            max_tokens=max_tokens, single_segment=single_segment,
                            no_timestamps=no_timestamps)

    kv_k, kv_v = M.init_kv_cache(cfg, 1, cache_dtype, device=dev,
                                 width=cache_rows(cfg, gamma))
    dkv_k, dkv_v = M.init_kv_cache(dcfg, 1, cache_dtype, device=dev,
                                   width=cache_rows(dcfg, gamma))

    # ---- prompt ingest, both models ----
    logits_all, kv_k, kv_v = M.decode_impl(cfg, dec, prompt, kv_k, kv_v, 0, xk, xv,
                                           logits_pos=t_real - 1)
    last_logits = logits_all[:, 0]                                   # (1, V)
    no_speech_prob = LR.compute_no_speech_prob(last_logits[0], token_nosp)
    _, dkv_k, dkv_v = M.decode_impl(dcfg, ddec, prompt, dkv_k, dkv_v, 0, dxk, dxv,
                                    logits_pos=t_real - 1)
    # K2's (L, T, S) views of the batch-1 caches and cross-KV
    nat = lambda *ts: tuple(t[:, 0] for t in ts)                     # noqa: E731

    # ---- prologue: the first token comes straight from the prompt logits ----
    yes = torch.ones(1, dtype=torch.bool, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    ms = machine_init(dev)
    tok, p, plog, pt, ptsum, tid = _choose(rc, last_logits, base_mask, init_mask,
                                           _rule_state(ms, token_beg, yes))
    is_ts = tok >= token_beg
    tid = torch.where(is_ts, tok, tid)
    pt = torch.where(is_ts, p, pt)
    ms, completed, failed = step(ms, tok[0], 0)

    zf = lambda: torch.zeros(n_max, dtype=torch.float32, device=dev)  # noqa: E731
    zl = lambda: torch.zeros(n_max, dtype=torch.long, device=dev)     # noqa: E731
    bufs = [zl(), zf(), zf(), zf(), zf(), zl()]    # tokens, p, plog, pt, ptsum, tid
    for b, v in zip(bufs, (tok, p, plog, pt, ptsum, tid)):
        b[0] = v[0]
    sum_lp = plog[0].clone()
    last_tok = tok                                                   # (1,)
    kv_head = t_real.clone()       # both models' next cache row (the same history)
    i = torch.ones((), dtype=torch.long, device=dev)                 # emitted tokens
    n_acc_total = torch.zeros((), dtype=torch.long, device=dev)
    n_rounds = torch.zeros((), dtype=torch.long, device=dev)
    ar = torch.arange(gamma + 1, device=dev)

    def draft_step(tok_in, head):
        """One draft step for the (1,) token at cache row `head`; (1, V) logits."""
        nonlocal dkv_k, dkv_v
        if dmega is not None:
            row, _, _ = MK.mega_decode_step(dcfg, dmega, _embed(ddec, tok_in, head.reshape(1)),
                                            *nat(dkv_k, dkv_v), head, *nat(dxk, dxv))
            return row
        lg, dkv_k, dkv_v = M.decode_impl(dcfg, ddec, tok_in[:, None], dkv_k, dkv_v, head,
                                         dxk, dxv)
        return lg[:, 0]

    for rnd in range(n_max):
        done = completed | failed | (i >= n_max)
        if rnd and rnd % POLL == 0 and reads.flag(done):
            break
        live = ~done

        # ---- draft proposals g_0..g_{gamma-1}; the rule inputs evolve with
        # them, the rest of the state machine is the acceptance scan's ----
        gs, g, dms, head = [], last_tok, ms, kv_head
        for j in range(gamma):
            row = draft_step(g, head)
            g = _choose(rc, row, base_mask, init_mask, _rule_state(dms, token_beg, no))[0]
            dms = step(dms, g[0], i + j)[0]
            gs.append(g)
            head = head + 1
        # the last step only ingests g_{gamma-1}, so the draft cache holds
        # every proposed token; its proposal would be discarded
        draft_step(g, head)

        # ---- target verify: one (gamma + 1)-token pass ----
        vseq = torch.cat([last_tok] + gs)                            # (gamma + 1,)
        if tmega is not None:
            vrows, _, _ = MK.mega_decode_step(cfg, tmega, _embed(dec, vseq, kv_head + ar),
                                              *nat(kv_k, kv_v), kv_head, *nat(xk, xv))
        else:
            vlogits, kv_k, kv_v = M.decode_impl(cfg, dec, vseq[None], kv_k, kv_v, kv_head,
                                                xk, xv)
            vrows = vlogits[0]                                       # (gamma + 1, V)

        # ---- acceptance scan: slot j emits token index i + j from row j ----
        active = live
        n_emit = torch.zeros((), dtype=torch.long, device=dev)
        n_acc = torch.zeros((), dtype=torch.long, device=dev)
        for j in range(gamma + 1):
            idx = i + j
            t, p, plog, pt, ptsum, tid = _choose(rc, vrows[j:j + 1], base_mask, init_mask,
                                                 _rule_state(ms, token_beg, no))
            is_ts = t >= token_beg
            tid = torch.where(is_ts, t, tid)
            pt = torch.where(is_ts, p, pt)
            emit = active
            # index_select/index_copy_: indexing with a device scalar would
            # read it to the host
            at = idx.clamp(max=n_max - 1).reshape(1)
            write = emit & (idx < n_max)
            for b, v in zip(bufs, (t, p, plog, pt, ptsum, tid)):
                b.index_copy_(0, at, torch.where(write, v.to(b.dtype), b.index_select(0, at)))
            ms2, comp, fail = step(ms, t[0], idx)
            match = (t[0] == gs[j][0]) if j < gamma else torch.zeros_like(emit)
            ms = ms2.where(emit, ms)
            completed = completed | (emit & comp)
            failed = failed | (emit & fail)
            last_tok = torch.where(emit, t, last_tok)
            n_emit = n_emit + emit.long()
            # accepted: a draft proposal emitted as it was, even when it ends the segment
            n_acc = n_acc + (emit & match).long()
            sum_lp = sum_lp + torch.where(emit, plog[0], 0.0)
            active = emit & match & ~comp & ~fail & (idx + 1 < n_max)

        kv_head = kv_head + n_emit
        i = i + n_emit
        n_acc_total = n_acc_total + n_acc
        n_rounds = n_rounds + live.long()

    tokens, p_buf, plog_buf, pt_buf, ptsum_buf, tid_buf = bufs
    res = SegmentResult(
        tokens=tokens, p=p_buf, plog=plog_buf, pt=pt_buf, ptsum=ptsum_buf, tid=tid_buf,
        n_tokens=i, result_len=ms.result_len, seek_delta=ms.seek_delta, has_ts=ms.has_ts,
        completed=completed, failed=failed, sum_logprobs_all=sum_lp,
        no_speech_prob=no_speech_prob)
    return res, n_acc_total, n_rounds


def decode_segment_speculative(cfg: M.WhisperConfig, dcfg: M.WhisperConfig,
                               rc: LR.RuleConfig, dec: M.Params, ddec: M.Params,
                               prompt: torch.Tensor, xk, xv, dxk, dxv,
                               base_mask: torch.Tensor, init_mask: torch.Tensor,
                               scalars, *, n_max: int, reads: HostReads, gamma: int = 4,
                               max_tokens: int = 0, single_segment: bool = False,
                               no_timestamps: bool = False,
                               cache_dtype: torch.dtype = torch.bfloat16,
                               dmega: MK.MegaParams | None = None,
                               tmega: MK.MegaParams | None = None):
    """Speculative greedy decode of one window; returns (SegmentResult,
    n_accepted, n_rounds). `scalars` = (t_real, token_nosp, seek, seek_end)
    ints, as decode_segment takes them. See speculative_core."""
    t_real, token_nosp, seek, seek_end = (int(x) for x in scalars)
    return speculative_core(
        cfg, dcfg, rc, dec, ddec, prompt, xk, xv, dxk, dxv, base_mask, init_mask,
        torch.tensor(t_real, dtype=torch.long, device=prompt.device), token_nosp, seek,
        seek_end, n_max=n_max, reads=reads, gamma=gamma, max_tokens=max_tokens,
        single_segment=single_segment, no_timestamps=no_timestamps,
        cache_dtype=cache_dtype, dmega=dmega, tmega=tmega)
