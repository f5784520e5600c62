"""Batched-window serving: B independent chunks decoded in lockstep.

Port of open_whisper_kit_tpu/decode/batch.py. whisper.cpp's multi-stream
path runs one OS thread per audio chunk (whisper_full_parallel,
src/whisper.cpp:7801-7929), each paying one graph launch per token. Here B
chunks decode together on the context's device: each round gathers the
B windows at per-chunk seek offsets, encodes them as one batch (kernel K6
in every linear of a W8A8 encoder, K1 in its attention), ingests the
prompt for all B streams with `decode_impl`, then advances all B greedy
decoders with the full rule set, one decoder step for all B per token.

The token loop runs on the device, as the JAX package's lax.while_loop
does: the host issues the steps without waiting and reads the loop's
done flag once every `POLL` steps; a step issued after every stream ended
changes nothing recorded, and the step counter `i` stops there, so
`BatchResult.n_tokens` is the JAX loop's `c.i`. The host reads one packed
result per round. Each token step is one call of kernel K8
(ops/decode_megakernel.py::mega_decode_step_batch, on the time-major
self-cache) when `FullParams.megakernel` asks for it (True, "int8",
"int4"; B <= 8, float cross-KV), else one `decode_impl` over the B streams
(with `cross_kv_int8`, its cross-attention through kernel K9b) on a self-cache
that starts 128 positions wide and widens to 256 (then the full context)
only when a step reaches that position: the masked columns add exact zeros
to the softmax, so the staged run equals the full-width one.

Semantics match whisper_full per chunk with no_context=True (chunk
boundaries are full_parallel's). Chunks whose QA gates trip re-run through
the single-stream whisper_full.

On a mesh context whose dp ranks divide the chunk count (the JAX package's
rule) each dp rank decodes its block of the chunks in a lockstep loop of
its own, and the blocks' results are all-gathered (parallel/mesh.fetch_np),
so every rank returns every chunk's segments; otherwise every rank decodes
every chunk.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..audio import mel as mel_mod
from ..models.whisper import model as M
from ..ops import decode_megakernel as MK
from ..parallel import mesh as X
from . import full as F
from . import logit_rules as LR
from .device_loop import POLL, HostReads
from .params import FullParams

CHUNK_FRAMES = 3000
DELTA_MIN = 10


@dataclasses.dataclass
class _BatchCarry:
    """The lockstep loop's per-stream state, all on the device: (B,)
    vectors and (B, n_max) token buffers; `i` a 0-d step counter that
    stops once every stream ended."""
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    kv_head: torch.Tensor
    i: torch.Tensor
    logits: torch.Tensor
    tokens: torch.Tensor
    p: torch.Tensor
    plog: torch.Tensor
    pt: torch.Tensor
    ptsum: torch.Tensor
    tid: torch.Tensor
    sum_lp: torch.Tensor
    last_was_ts: torch.Tensor
    penult_was_ts: torch.Tensor
    has_ts: torch.Tensor
    seek_delta: torch.Tensor
    result_len: torch.Tensor
    completed: torch.Tensor
    failed: torch.Tensor


_RESULT_BUFS = ("tokens", "p", "plog", "pt", "ptsum", "tid")
_RESULT_ROWS = ("n_tokens", "result_len", "seek_delta", "has_ts", "completed",
                "failed", "sum_lp", "no_speech_prob")


@dataclasses.dataclass
class BatchResult:
    """One round's per-stream outputs (numpy on the host)."""
    tokens: np.ndarray          # (B, n_max)
    p: np.ndarray
    plog: np.ndarray
    pt: np.ndarray
    ptsum: np.ndarray
    tid: np.ndarray
    n_tokens: np.ndarray        # (B,) sampled steps == the loop's global i
    result_len: np.ndarray
    seek_delta: np.ndarray
    has_ts: np.ndarray
    completed: np.ndarray
    failed: np.ndarray
    sum_lp: np.ndarray
    no_speech_prob: np.ndarray


def _fetch_result(c: _BatchCarry, nsp: torch.Tensor, reads: HostReads) -> BatchResult:
    """Every output of a round in ONE device-to-host read (all values are
    exactly representable in f32)."""
    B, n_max = c.tokens.shape
    rows = {"n_tokens": c.i.expand(B), "result_len": c.result_len,
            "seek_delta": c.seek_delta, "has_ts": c.has_ts, "completed": c.completed,
            "failed": c.failed, "sum_lp": c.sum_lp, "no_speech_prob": nsp}
    flat = reads.fetch(torch.cat([getattr(c, n).float() for n in _RESULT_BUFS]
                                 + [rows[n].float()[:, None] for n in _RESULT_ROWS], dim=1))
    out, at = {}, 0
    for n in _RESULT_BUFS:
        out[n] = flat[:, at:at + n_max]
        at += n_max
    for n in _RESULT_ROWS:
        out[n] = flat[:, at]
        at += 1
    for n in ("tokens", "tid", "n_tokens", "result_len", "seek_delta"):
        out[n] = out[n].astype(np.int64)
    for n in ("has_ts", "completed", "failed"):
        out[n] = out[n] != 0
    return BatchResult(**out)


def _gather_windows(mel_data: torch.Tensor, seeks: np.ndarray, n_ctx: int) -> torch.Tensor:
    """(n_len, n_mel), (B,) -> (B, 2*n_ctx, n_mel): each stream's window at
    its seek, the start clamped into the buffer as a dynamic slice clamps
    it (only a stream that has ended can reach past its chunk)."""
    starts = np.clip(np.asarray(seeks, np.int64), 0, mel_data.shape[0] - 2 * n_ctx)
    idx = (torch.as_tensor(starts, device=mel_data.device)[:, None]
           + torch.arange(2 * n_ctx, device=mel_data.device)[None, :])
    return mel_data[idx]


@dataclasses.dataclass(frozen=True)
class _StaticArgs:
    cfg: M.WhisperConfig
    rc: LR.RuleConfig
    n_max: int
    max_tokens: int
    no_timestamps: bool
    stub: bool
    cross_kv_int8: bool = False   # int8 QuantKV cross-KV planes (kernel K9b)
    # staged self-KV widths of the decode_impl branch: the cache is only as
    # wide as the positions reached so far (128 -> 256 covers a whole
    # no-context batched decode, n_max = n_text_ctx/2 - 4); masked columns
    # add exact zeros to the softmax
    kv_stages: tuple = ()


def _kv_stage_widths(full: int, need: int) -> tuple:
    """Stage widths (ascending) ending at the narrowest of {128, 256, full}
    that covers `need` positions."""
    need = min(need, full)
    last = min(next((w for w in (128, 256) if w >= need), full), full)
    return tuple(w for w in (128, 256) if w < last) + (last,)


def _make_batch_step(sa: _StaticArgs, reads: HostReads):
    """The round function: encode the B windows, ingest the prompt, run the
    lockstep token loop; returns the packed round result on the host."""
    cfg, rc = sa.cfg, sa.rc
    token_beg, token_eot = rc.token_beg, rc.token_eot

    def run(params, mel_data, seeks, active, prompt, kv_k, kv_v,
            base_mask, init_mask, token_nosp, seek_end, mega=None) -> BatchResult:
        dec = params["decoder"]
        dev = mel_data.device
        B = len(seeks)
        windows = _gather_windows(mel_data, seeks, cfg.n_audio_ctx)
        _, xk, xv = M.encode_with_cross_kv(cfg, params["encoder"], dec, windows)
        if sa.cross_kv_int8:
            # halves the cross-KV bytes every lockstep step reads
            xk = M.quantize_cross_kv(xk, cfg.n_text_head)
            xv = M.quantize_cross_kv(xv, cfg.n_text_head)

        t_prompt = prompt.shape[1]
        prompts = prompt.expand(B, t_prompt)
        if mega is not None:
            # K8 steps on a time-major (L, Tc*B, S) cache; the prompt is
            # ingested by decode_impl on the natural (L, B, Tc, S) cache
            L, S, Tc = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_ctx
            nk, nv = M.init_kv_cache(cfg, B, dtype=torch.bfloat16, device=dev)
            logits_all, nk, nv = M.decode_impl(cfg, dec, prompts, nk, nv, 0, xk, xv,
                                               logits_pos=t_prompt - 1)
            kv_k = nk.transpose(1, 2).reshape(L, Tc * B, S)
            kv_v = nv.transpose(1, 2).reshape(L, Tc * B, S)
        else:
            logits_all, kv_k, kv_v = M.decode_impl(cfg, dec, prompts, kv_k, kv_v, 0,
                                                   xk, xv, logits_pos=t_prompt - 1)
        last_logits = logits_all[:, 0]                              # (B, V)
        nsp = LR.compute_no_speech_prob(last_logits, token_nosp)

        zf = lambda: torch.zeros(B, sa.n_max, dtype=torch.float32, device=dev)  # noqa: E731
        zl = lambda: torch.zeros(B, sa.n_max, dtype=torch.long, device=dev)     # noqa: E731
        bvec = lambda v, dt: torch.full((B,), v, dtype=dt, device=dev)        # noqa: E731
        active_d = torch.as_tensor(active, device=dev)
        c = _BatchCarry(
            kv_k=kv_k, kv_v=kv_v,
            kv_head=torch.tensor(t_prompt, dtype=torch.long, device=dev),
            i=torch.zeros((), dtype=torch.long, device=dev), logits=last_logits,
            tokens=zl(), p=zf(), plog=zf(), pt=zf(), ptsum=zf(), tid=zl(),
            sum_lp=bvec(0.0, torch.float32), last_was_ts=bvec(False, torch.bool),
            penult_was_ts=bvec(True, torch.bool), has_ts=bvec(False, torch.bool),
            seek_delta=bvec(CHUNK_FRAMES, torch.long), result_len=bvec(0, torch.long),
            completed=~active_d, failed=bvec(False, torch.bool))
        seeks_d = torch.as_tensor(np.asarray(seeks, np.int64), device=dev)
        seek_end_d = torch.as_tensor(np.asarray(seek_end, np.int64), device=dev)
        initial = (bvec(True, torch.bool), bvec(False, torch.bool))
        stages = list(sa.kv_stages) if mega is None else []

        for i in range(sa.n_max):
            if i and i % POLL == 0 and reads.flag((c.completed | c.failed).all()):
                break
            run_mask = ~c.completed & ~c.failed                    # (B,)
            st = LR.BeamState(
                is_initial=initial[0] if i == 0 else initial[1],
                last_was_ts=c.last_was_ts, penult_was_ts=c.penult_was_ts,
                has_ts=c.has_ts,
                ts_min=torch.where(c.has_ts, token_beg + c.seek_delta // 2, 0))
            f_logits, f_logprobs, f_probs = LR.apply_rules(
                rc, c.logits, base_mask, init_mask, st, 0.0)
            tok, p, plog, pt, ptsum, tid = LR.sample_greedy(
                rc, f_logits, f_logprobs, f_probs)
            is_ts_tok = tok >= token_beg
            tid = torch.where(is_ts_tok, tok, tid)
            pt = torch.where(is_ts_tok, p, pt)

            # column i is written once: a masked stream keeps its zero
            c.tokens[:, i] = torch.where(run_mask, tok, 0)
            c.p[:, i] = torch.where(run_mask, p, 0.0)
            c.plog[:, i] = torch.where(run_mask, plog, 0.0)
            c.pt[:, i] = torch.where(run_mask, pt, 0.0)
            c.ptsum[:, i] = torch.where(run_mask, ptsum, 0.0)
            c.tid[:, i] = torch.where(run_mask, tid, 0)
            c.sum_lp = torch.where(run_mask, c.sum_lp + plog, c.sum_lp)

            # state machine (whisper.cpp:7355-7459), vectorized over B
            gt_beg = (tok > token_beg) & run_mask
            sd_new = 2 * (tok - token_beg)
            ts_fail = gt_beg & c.has_ts & (c.seek_delta > sd_new) & (c.result_len < i)
            take_ts = gt_beg & ~ts_fail
            seek_delta = torch.where(take_ts, sd_new, c.seek_delta)
            result_len = torch.where(take_ts, i + 1, c.result_len)
            has_ts = c.has_ts | take_ts

            at_end = seeks_d + seek_delta + DELTA_MIN >= seek_end_d
            end_hit = run_mask & ~ts_fail & (
                (tok == token_eot) | bool(sa.max_tokens > 0 and i >= sa.max_tokens)
                | (has_ts & at_end))
            rl_zero = (result_len == 0) & (not sa.no_timestamps)
            end_fail = end_hit & rl_zero & ~at_end
            result_len = torch.where(end_hit & rl_zero & at_end, i + 1, result_len)
            end_ok = end_hit & ~end_fail
            if sa.no_timestamps:
                result_len = torch.where(end_ok, i + 1, result_len)
                seek_delta = torch.where(end_ok, CHUNK_FRAMES, seek_delta)
            completed = c.completed | end_ok
            failed = c.failed | ts_fail | end_fail
            if sa.stub:
                newly = run_mask & ~completed & ~failed
                seek_delta = torch.where(newly, CHUNK_FRAMES, seek_delta)
                completed = completed | newly
            if i == sa.n_max - 1:   # repetition-loop bail-out (whisper.cpp:7440-7445)
                failed = failed | (run_mask & ~completed & ~failed & (
                    (result_len == 0) | (seek_delta < CHUNK_FRAMES // 2)))

            c.penult_was_ts = torch.where(run_mask, c.last_was_ts | (i == 0),
                                          c.penult_was_ts)
            c.last_was_ts = torch.where(run_mask, is_ts_tok, c.last_was_ts)
            c.has_ts, c.seek_delta, c.result_len = has_ts, seek_delta, result_len
            c.completed, c.failed = completed, failed
            c.i = c.i + run_mask.any()

            # ---- the next decoder step (its logits unused after the last) ----
            if i + 1 < sa.n_max:
                if mega is not None:
                    # index_select: a 0-d tensor index would read it to the host
                    x0 = (dec["te"].index_select(0, tok)
                          + dec["pe"].index_select(0, c.kv_head.reshape(1))
                          ).to(torch.bfloat16)
                    c.logits, c.kv_k, c.kv_v = MK.mega_decode_step_batch(
                        cfg, mega, x0, c.kv_k, c.kv_v, c.kv_head, xk, xv)
                else:
                    if stages and t_prompt + i >= c.kv_k.shape[2]:
                        while stages[0] <= t_prompt + i:
                            stages.pop(0)
                        c.kv_k = M.widen_kv_cache(c.kv_k, stages[0])
                        c.kv_v = M.widen_kv_cache(c.kv_v, stages[0])
                    step_logits, c.kv_k, c.kv_v = M.decode_impl(
                        cfg, dec, tok[:, None], c.kv_k, c.kv_v, c.kv_head, xk, xv)
                    c.logits = step_logits[:, 0]
                c.kv_head = c.kv_head + 1
        return _fetch_result(c, nsp, reads)

    return run


def _init_prompt(ctx: F.WhisperContext, p: FullParams) -> list[int]:
    vocab = ctx.vocab
    prompt_init = [vocab.token_sot]
    if vocab.is_multilingual:
        from . import tokenizer as tok_mod
        lid = tok_mod.lang_id(p.language or "en")
        prompt_init += [vocab.token_lang(lid),
                        vocab.token_translate if p.translate
                        else vocab.token_transcribe]
    if p.no_timestamps:
        prompt_init.append(vocab.token_not)
    return prompt_init


def _lockstep_chunks(ctx: F.WhisperContext, p: FullParams, mel_data: torch.Tensor,
                     bases: np.ndarray, ends_local: np.ndarray, fallback_audio,
                     split: bool = True):
    """Lockstep-decode B independent chunks laid out in one mel buffer.

    Chunk b's frames live at mel_data[bases[b] : bases[b]+ends_local[b]]
    (plus window zero-pad). Returns (per-chunk segments with CHUNK-LOCAL
    timestamps, per-chunk Timings). `fallback_audio(b)` yields the chunk's
    samples for the QA-gate re-run through the single-stream driver.
    `p.cross_kv_int8` (the JAX package's `cross_kv_int8` argument) quantizes
    each round's cross-KV to int8 planes: the lockstep steps then run kernel
    K9b, and K8 stays off, as in the JAX package. Options that change the
    step program (grammar, timestamps, VAD, callbacks) are not applied here,
    as in the JAX package: `transcribe_batch` and `full_parallel` route them
    to whisper_full, and a chunk sent to the fallback gets them there.
    `split`: on a mesh, share the chunks out over its dp ranks (module
    docstring)."""
    cfg = ctx.cfg
    vocab = ctx.vocab
    B = len(bases)
    dp = X.axis_size(ctx.mesh, "dp")
    if split and dp > 1 and B % dp == 0:
        r = X.axis_rank(ctx.mesh, "dp")
        mine = slice(r * B // dp, (r + 1) * B // dp)
        segs, tms = _lockstep_chunks(ctx, p, mel_data, np.asarray(bases)[mine],
                                     np.asarray(ends_local)[mine],
                                     lambda b: fallback_audio(mine.start + b), split=False)
        return X.fetch_np(segs, ctx.mesh), X.fetch_np(tms, ctx.mesh)

    prompt_init = _init_prompt(ctx, p)
    base_mask, init_mask = ctx.rule_masks(p)
    n_max = cfg.n_text_ctx // 2 - 4
    # no-context lockstep decode: positions never pass prompt + n_max (+1
    # for the bonus write slot), so the self-KV cache starts narrow
    kv_stages = _kv_stage_widths(cfg.n_text_ctx, len(prompt_init) + n_max + 1)
    sa = _StaticArgs(cfg=cfg, rc=ctx.rule_config, n_max=n_max, max_tokens=p.max_tokens,
                     no_timestamps=p.no_timestamps, stub=ctx.n_loaded == 0,
                     cross_kv_int8=p.cross_kv_int8, kv_stages=kv_stages)
    step = _make_batch_step(sa, ctx.reads)
    # K8 on explicit opt-in only, as in the JAX package (its first-cut TPU
    # kernel was slower than the XLA batch step, so "auto" never picks it);
    # it does not take int8 cross-KV planes
    mega = (ctx.mega_params(p) if p.megakernel in (True, "int8", "int4") and B <= 8
            and not p.cross_kv_int8 else None)

    bases = np.asarray(bases, np.int64)
    seeks = bases.copy()                          # absolute frame cursors
    ends = bases + np.asarray(ends_local, np.int64)
    chunk_segments: list[list[F.Segment]] = [[] for _ in range(B)]
    chunk_timings = [F.Timings() for _ in range(B)]
    failed_chunks: set[int] = set()
    prompt = torch.tensor([prompt_init], dtype=torch.long, device=ctx.device)

    while True:
        active = (seeks + DELTA_MIN < ends) & ~np.isin(np.arange(B), list(failed_chunks))
        if not active.any():
            break
        if mega is not None:      # K8 lays its cache out after the prompt ingest
            kv_k = kv_v = None
        else:
            kv_k, kv_v = M.init_kv_cache(cfg, B, dtype=ctx.dtype, device=ctx.device,
                                         width=kv_stages[0])
        t0 = time.perf_counter()
        res = step(ctx.params, mel_data, seeks, active, prompt, kv_k, kv_v,
                   base_mask, init_mask, vocab.token_nosp, ends, mega=mega)
        round_ms = (time.perf_counter() - t0) * 1e3
        n_active = max(1, int(active.sum()))

        for b in range(B):
            if not active[b]:
                continue
            tm = chunk_timings[b]
            tm.t_decode_ms += round_ms / n_active
            tm.n_encode += 1
            tm.n_decode += int(res.n_tokens[b]) + 1
            tm.n_sample += int(res.n_tokens[b])
            if res.failed[b]:
                failed_chunks.add(b)
                continue
            n_tok = int(res.n_tokens[b])
            tokens = [F.TokenData(int(res.tokens[b, k]), int(res.tid[b, k]),
                                  float(res.p[b, k]), float(res.plog[b, k]),
                                  float(res.pt[b, k]), float(res.ptsum[b, k]))
                      for k in range(n_tok)]
            tokens_cur = tokens[:int(res.result_len[b])]
            sd = int(res.seek_delta[b])
            sub = F.TranscribeResult(segments=chunk_segments[b])
            if tokens_cur and ctx.n_loaded > 0:
                F._emit_segments(ctx, p, sub, tokens_cur, int(seeks[b] - bases[b]), sd,
                                 float(res.no_speech_prob[b]))
            single_ts_end = (len(tokens_cur) > 1
                             and tokens_cur[-2].id < vocab.token_beg
                             and tokens_cur[-1].id > vocab.token_beg)
            if single_ts_end:
                sd = min(int(ends[b]) - int(seeks[b]), CHUNK_FRAMES)
            seeks[b] += sd

    # QA-gate fallback: failed chunks re-run through the single-stream driver
    for b in sorted(failed_chunks):
        sub = F.whisper_full(ctx, dataclasses.replace(
            p, offset_ms=0, duration_ms=0, print_progress=False), fallback_audio(b))
        chunk_segments[b] = sub.segments
        chunk_timings[b] = sub.timings
    return chunk_segments, chunk_timings


def _pad_rows(data: torch.Tensor, rows: int) -> torch.Tensor:
    """The first `rows` rows of `data`, zero rows appended where it is shorter."""
    if data.shape[0] >= rows:
        return data[:rows]
    return torch.cat([data, data.new_zeros(rows - data.shape[0], data.shape[1])])


def transcribe_batched(ctx: F.WhisperContext, p: FullParams, samples: np.ndarray,
                       n_chunks: int = 8) -> F.TranscribeResult:
    """Transcribe by splitting into `n_chunks` independent chunks and
    decoding all their windows in lockstep on the device. Greedy t=0 path;
    chunks whose QA gates trip fall back to the single-stream driver. All
    chunks share ONE whole-audio mel (offset/duration single-stream
    semantics; full_parallel uses per-chunk mels via transcribe_chunks)."""
    samples = np.asarray(samples, np.float32)
    if n_chunks <= 1:
        return F.whisper_full(ctx, p, samples)

    cfg = ctx.cfg
    mel = mel_mod.log_mel_spectrogram(samples, ctx.filters, device=ctx.device)
    # a full window fits at any seek < n_len_org (zero-padded like
    # whisper_encode_internal's window buffer, whisper.cpp:2392-2399)
    data = mel.data
    need = mel.n_len_org + 2 * cfg.n_audio_ctx
    if data.shape[0] < need:
        data = _pad_rows(data, need)
    n_per = mel.n_len_org // n_chunks
    bases = np.array([i * n_per for i in range(n_chunks)], np.int64)
    ends_local = np.array(
        [(mel.n_len_org if i == n_chunks - 1 else (i + 1) * n_per) - i * n_per
         for i in range(n_chunks)], np.int64)

    def fallback_audio(b):
        lo = int(bases[b])
        return samples[lo * 160:(lo + int(ends_local[b])) * 160]

    chunk_segments, chunk_timings = _lockstep_chunks(ctx, p, data, bases, ends_local,
                                                     fallback_audio)
    result = F.TranscribeResult(segments=[], timings=chunk_timings[0])
    for tm in chunk_timings[1:]:
        result.timings.t_decode_ms += tm.t_decode_ms
        result.timings.n_encode += tm.n_encode
        result.timings.n_decode += tm.n_decode
        result.timings.n_sample += tm.n_sample
    for b in range(n_chunks):
        for s in chunk_segments[b]:
            s.t0 += int(bases[b])
            s.t1 += int(bases[b])
            if result.segments:
                s.t0 = max(s.t0, result.segments[-1].t1)
            result.segments.append(s)
    return result


def transcribe_chunks(ctx: F.WhisperContext, p: FullParams,
                      chunks: list[np.ndarray]) -> list[list[F.Segment]]:
    """Lockstep-decode a list of independent audio chunks, each with its OWN
    mel normalization context (what whisper_full computes per chunk: the
    whisper_full_parallel per-state semantics, whisper.cpp:7801-7929).
    Returns per-chunk segments with chunk-local timestamps; the caller owns
    offset fixup and merging (parallel/dp.py::full_parallel)."""
    segs, _ = transcribe_chunks_with_timings(ctx, p, chunks)
    return segs


def transcribe_chunks_with_timings(ctx: F.WhisperContext, p: FullParams,
                                   chunks: list[np.ndarray]):
    """transcribe_chunks + per-chunk Timings (full_parallel's merge input)."""
    pad = 2 * ctx.cfg.n_audio_ctx
    mels = [mel_mod.log_mel_spectrogram(np.asarray(c, np.float32), ctx.filters,
                                        device=ctx.device) for c in chunks]
    parts = [_pad_rows(m.data, m.n_len_org + pad) for m in mels]
    bases = np.cumsum([0] + [d.shape[0] for d in parts[:-1]]).astype(np.int64)
    mel_data = torch.cat(parts) if len(parts) > 1 else parts[0]
    ends_local = np.array([m.n_len_org for m in mels], np.int64)
    return _lockstep_chunks(ctx, p, mel_data, bases, ends_local, lambda b: chunks[b])
