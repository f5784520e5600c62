"""On-device greedy segment decoder (port of
open_whisper_kit_tpu/decode/device_loop.py).

The t=0 greedy segment decode -- prompt ingest, no-speech probability, the
full logit rule-set, argmax sampling and the sliding-window/EOT state
machine (whisper.cpp:7355-7459) -- runs as tensor ops on the context's
device. The JAX side fuses it into one lax.while_loop; here the host issues
the steps without waiting and reads the loop's done flag only once every
`POLL` tokens. Steps issued after the segment completed or failed are
masked, so they change no recorded output, and their cache slot is clamped
inside n_text_ctx. The host reads one packed result per segment. With `mega` (MegaParams)
each token step is one call of the decode-step kernel K2
(ops/decode_megakernel.py); the prompt ingest stays on `decode_impl`.
With `grammar` (GrammarOps, a grammar's token automaton as tensors) each
step adds the automaton state's penalty row after the step's logits and
steps the state on the sampled token, on the device: a grammar window
reads the host no more often than a grammar-free one.
`HostReads` counts every device-to-host read these loops make.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.whisper import model as M
from ..ops import decode_megakernel as MK
from . import logit_rules as LR

CHUNK_FRAMES = 3000  # 100 * WHISPER_CHUNK_SIZE
POLL = 16            # tokens between host reads of the loop's done flag


@dataclasses.dataclass
class GrammarOps:
    """A grammar's token automaton (grammar.GrammarDFA) as tensors on the
    loop's device, with its penalty; lets a grammar window stay in the
    on-device loop instead of the host-stepped one."""
    allowed: torch.Tensor   # (n_states, A) long, pad = n_vocab
    nxt: torch.Tensor       # (n_states, A) long
    cand: torch.Tensor      # (V,) f32
    skip: torch.Tensor      # (V,) bool
    dead: torch.Tensor      # 0-d long
    penalty: torch.Tensor   # 0-d f32

    @classmethod
    def from_dfa(cls, dfa, penalty: float, device) -> "GrammarOps":
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        return cls(allowed=t(dfa.allowed, torch.long), nxt=t(dfa.nxt, torch.long),
                   cand=t(dfa.cand, torch.float32), skip=t(dfa.skip, torch.bool),
                   dead=t(dfa.dead, torch.long),
                   penalty=t(np.float32(penalty), torch.float32))


def grammar_mask_row(g: GrammarOps, state: torch.Tensor) -> torch.Tensor:
    """(V,) additive penalty row for automaton state `state` (0-d long).
    The allowed ids are padded with n_vocab: they land in a spare last
    column, which is dropped (JAX's scatter mode="drop")."""
    V = g.cand.shape[0]
    row = torch.cat([g.cand * -g.penalty, g.cand.new_zeros(1)])
    arow = g.allowed.index_select(0, state.reshape(1))[0]
    return row.index_fill_(0, arow, 0.0)[:V]


def grammar_step(g: GrammarOps, state: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Next automaton state after sampling `tok` (GrammarDFA.step), with no
    host read: both 0-d long tensors."""
    s = state.reshape(1)
    hit = g.allowed.index_select(0, s)[0] == tok
    # the first hit (argmax has no bool kernel on CUDA)
    j = hit.to(torch.int32).argmax().reshape(1)
    nxt = torch.where(hit.any(), g.nxt.index_select(0, s)[0].index_select(0, j)[0], g.dead)
    return torch.where(g.skip.index_select(0, tok.reshape(1))[0], state, nxt)


class HostReads:
    """Counts the device-to-host reads of the decode loops."""

    def __init__(self):
        self.n = 0

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """Copy `t` to host memory (one read, which waits for the device)."""
        self.n += 1
        return t.detach().cpu().numpy()

    def flag(self, t: torch.Tensor) -> bool:
        self.n += 1
        return bool(t.item())


@dataclasses.dataclass
class MachineState:
    """Per-decoder token state machine variables (whisper.cpp:7355-7459);
    all 0-d tensors."""
    last_was_ts: torch.Tensor
    penult_was_ts: torch.Tensor
    has_ts: torch.Tensor
    seek_delta: torch.Tensor
    result_len: torch.Tensor

    def where(self, cond: torch.Tensor, other: "MachineState") -> "MachineState":
        """Field-wise torch.where(cond, self, other)."""
        return MachineState(*(torch.where(cond, a, b) for a, b in zip(
            dataclasses.astuple(self), dataclasses.astuple(other))))


def machine_init(device) -> MachineState:
    t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)
    return MachineState(last_was_ts=t(False, torch.bool),
                        penult_was_ts=t(True, torch.bool),
                        has_ts=t(False, torch.bool),
                        seek_delta=t(CHUNK_FRAMES, torch.long),
                        result_len=t(0, torch.long))


def machine_step(ms: MachineState, tok, i, *, token_beg, token_eot,
                 seek, seek_end, n_max: int, max_tokens: int,
                 single_segment: bool, no_timestamps: bool,
                 stub: bool = False):
    """One token through the whisper.cpp:7355-7459 state machine.

    `tok` (0-d tensor) was just sampled at segment-token index `i` (an int,
    or a 0-d tensor in the speculative loop, whose index lives on the
    device). `seek` may be an int or a 0-d tensor. Returns (new
    MachineState, completed, failed)."""
    delta_min = 10
    is_ts_tok = tok >= token_beg
    gt_beg = tok > token_beg
    sd_new = 2 * (tok - token_beg)
    ts_fail = (gt_beg & ms.has_ts & (ms.seek_delta > sd_new)
               & (ms.result_len < i))
    take_ts = gt_beg & ~ts_fail
    seek_delta = torch.where(take_ts, sd_new, ms.seek_delta)
    result_len = torch.where(take_ts, i + 1, ms.result_len)
    has_ts = ms.has_ts | take_ts

    end_hit = ((tok == token_eot)
               | ((i >= max_tokens) if max_tokens > 0 else False)
               | (has_ts & (seek + seek_delta + delta_min >= seek_end)))
    end_hit = end_hit & ~ts_fail
    at_audio_end = seek + seek_delta + delta_min >= seek_end
    rl_zero = (result_len == 0) & (not no_timestamps)
    end_fail = end_hit & rl_zero & ~at_audio_end
    result_len = torch.where(end_hit & rl_zero & at_audio_end, i + 1, result_len)
    end_ok = end_hit & ~end_fail
    if single_segment or no_timestamps:
        result_len = torch.where(end_ok, i + 1, result_len)
        seek_delta = torch.where(end_ok, CHUNK_FRAMES, seek_delta)
    completed = end_ok
    failed = ts_fail | end_fail

    if stub:  # weightless test checkpoints (whisper.cpp:7426-7431)
        seek_delta = torch.where(~completed & ~failed, CHUNK_FRAMES, seek_delta)
        completed = completed | ~failed

    # repetition-loop bail-out at the last step (whisper.cpp:7440-7445)
    rep_fail = ((i == n_max - 1) & ~completed & ~failed
                & ((result_len == 0) | (seek_delta < CHUNK_FRAMES // 2)))
    failed = failed | rep_fail

    return MachineState(
        last_was_ts=is_ts_tok,
        penult_was_ts=ms.last_was_ts | (i == 0),
        has_ts=has_ts, seek_delta=seek_delta,
        result_len=result_len), completed, failed


@dataclasses.dataclass
class SegmentResult:
    tokens: torch.Tensor      # (n_max,) long
    p: torch.Tensor           # (n_max,) f32
    plog: torch.Tensor
    pt: torch.Tensor
    ptsum: torch.Tensor
    tid: torch.Tensor         # (n_max,) long
    n_tokens: torch.Tensor    # number sampled
    result_len: torch.Tensor
    seek_delta: torch.Tensor
    has_ts: torch.Tensor
    completed: torch.Tensor
    failed: torch.Tensor
    sum_logprobs_all: torch.Tensor
    no_speech_prob: torch.Tensor


def segment_core(cfg: M.WhisperConfig, rc: LR.RuleConfig,
                 dec: M.Params, prompt: torch.Tensor,
                 kv_k: torch.Tensor, kv_v: torch.Tensor,
                 xk: torch.Tensor, xv: torch.Tensor,
                 base_mask: torch.Tensor, init_mask: torch.Tensor,
                 t_real: torch.Tensor, token_nosp: int, seek, seek_end: int, *,
                 n_max: int, reads: HostReads, max_tokens: int = 0,
                 single_segment: bool = False, no_timestamps: bool = False,
                 stub: bool = False, mega: MK.MegaParams | None = None,
                 grammar: GrammarOps | None = None) -> SegmentResult:
    """Greedy segment decode on the prompt's device; shared by the one-window
    `decode_segment` and the K-windows loop in decode/device_windows.py.

    prompt (1, T_pad) long; xk/xv the window's cross-KV, float or QuantKV
    planes (`mega` reads the float cross-KV only); `t_real` a 0-d long
    tensor (the real prompt length, so the window loop can build the prompt
    on the device); `seek` an int or a 0-d tensor. kv_k/kv_v (L,1,n_ctx,S)
    are overwritten in place. The loop runs at most n_max steps and stops at the first
    `reads.flag` poll (every POLL steps) after the segment ended."""
    token_beg, token_eot = rc.token_beg, rc.token_eot
    dev = prompt.device
    n_ctx = kv_k.shape[2]

    # ---- prompt ingest (logits only at the last real position) ----
    logits_all, kv_k, kv_v = M.decode_impl(cfg, dec, prompt, kv_k, kv_v, 0,
                                           xk, xv, logits_pos=t_real - 1)
    logits = logits_all[:, 0]                              # (1, V)
    no_speech_prob = LR.compute_no_speech_prob(logits[0], token_nosp)
    if mega is not None:   # the kernel's (L, T, S) views of the batch-1 caches
        nat = kv_k[:, 0], kv_v[:, 0], xk[:, 0], xv[:, 0]

    zf = lambda: torch.zeros(n_max, dtype=torch.float32, device=dev)
    zl = lambda: torch.zeros(n_max, dtype=torch.long, device=dev)
    tokens, tid_buf = zl(), zl()
    p_buf, plog_buf, pt_buf, ptsum_buf = zf(), zf(), zf(), zf()
    sum_lp = torch.zeros((), dtype=torch.float32, device=dev)
    n_tok = torch.zeros((), dtype=torch.long, device=dev)
    ms = machine_init(dev)
    gstate = torch.zeros((), dtype=torch.long, device=dev)   # grammar automaton state
    completed = torch.zeros((), dtype=torch.bool, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    initial = (torch.ones(1, dtype=torch.bool, device=dev),
               torch.zeros(1, dtype=torch.bool, device=dev))

    for i in range(n_max):
        if i and i % POLL == 0 and reads.flag(completed | failed):
            break
        active = ~(completed | failed)
        st = LR.BeamState(
            is_initial=initial[0] if i == 0 else initial[1],
            last_was_ts=ms.last_was_ts[None],
            penult_was_ts=ms.penult_was_ts[None],
            has_ts=ms.has_ts[None],
            ts_min=torch.where(ms.has_ts, token_beg + ms.seek_delta // 2, 0)[None])
        gmask = grammar_mask_row(grammar, gstate)[None] if grammar is not None else None
        f_logits, f_logprobs, f_probs = LR.apply_rules(
            rc, logits, base_mask, init_mask, st, 0.0, gmask)
        tok, p, plog, pt, ptsum, tid = LR.sample_greedy(
            rc, f_logits, f_logprobs, f_probs)
        tok0 = tok[0]
        if grammar is not None:
            gstate = torch.where(active, grammar_step(grammar, gstate, tok0), gstate)
        is_ts_tok = tok0 >= token_beg
        # a masked step records the buffers' initial zeros
        tokens[i] = torch.where(active, tok0, 0)
        p_buf[i] = torch.where(active, p[0], 0.0)
        plog_buf[i] = torch.where(active, plog[0], 0.0)
        pt_buf[i] = torch.where(active, torch.where(is_ts_tok, p[0], pt[0]), 0.0)
        ptsum_buf[i] = torch.where(active, ptsum[0], 0.0)
        tid_buf[i] = torch.where(active, torch.where(is_ts_tok, tok0, tid[0]), 0)
        sum_lp = sum_lp + torch.where(active, plog[0], 0.0)
        n_tok = n_tok + active.long()

        # ---- state machine (whisper.cpp:7355-7459) ----
        ms_new, comp, fail = machine_step(
            ms, tok0, i, token_beg=token_beg, token_eot=token_eot,
            seek=seek, seek_end=seek_end, n_max=n_max,
            max_tokens=max_tokens, single_segment=single_segment,
            no_timestamps=no_timestamps, stub=stub)
        ms = ms_new.where(active, ms)
        completed = completed | (active & comp)
        failed = failed | (active & fail)

        # ---- next decode step (unused after the last live step) ----
        if i + 1 < n_max:
            kv_head = torch.clamp(t_real + i, max=n_ctx - 1)
            if mega is not None:
                # index_select: indexing with a 0-d tensor would read it to the host
                x0 = (dec["te"][tok] + dec["pe"].index_select(0, kv_head.reshape(1))
                      ).to(torch.bfloat16)
                logits, _, _ = MK.mega_decode_step(cfg, mega, x0, nat[0], nat[1],
                                                   kv_head, nat[2], nat[3])
            else:
                step_logits, kv_k, kv_v = M.decode_impl(
                    cfg, dec, tok[:, None], kv_k, kv_v, kv_head, xk, xv)
                logits = step_logits[:, 0]

    return SegmentResult(
        tokens=tokens, p=p_buf, plog=plog_buf, pt=pt_buf, ptsum=ptsum_buf,
        tid=tid_buf, n_tokens=n_tok, result_len=ms.result_len,
        seek_delta=ms.seek_delta, has_ts=ms.has_ts, completed=completed,
        failed=failed, sum_logprobs_all=sum_lp, no_speech_prob=no_speech_prob)


def decode_segment(cfg: M.WhisperConfig, rc: LR.RuleConfig,
                   dec: M.Params, prompt: torch.Tensor,
                   xk: torch.Tensor, xv: torch.Tensor,
                   base_mask: torch.Tensor, init_mask: torch.Tensor,
                   scalars, *, n_max: int, reads: HostReads,
                   max_tokens: int = 0, single_segment: bool = False,
                   no_timestamps: bool = False, stub: bool = False,
                   cache_dtype: torch.dtype = torch.bfloat16,
                   mega: MK.MegaParams | None = None,
                   grammar: GrammarOps | None = None) -> SegmentResult:
    """Greedy-decode one window. prompt (1, T_pad) long; `scalars` =
    (t_real, token_nosp, seek, seek_end) ints. The self-KV cache is
    allocated here: a window always starts from an empty cache. `grammar`:
    the token automaton whose penalties constrain the window."""
    t_real, token_nosp, seek, seek_end = (int(x) for x in scalars)
    kv_k, kv_v = M.init_kv_cache(cfg, 1, dtype=cache_dtype, device=prompt.device)
    t_real_d = torch.tensor(t_real, dtype=torch.long, device=prompt.device)
    return segment_core(
        cfg, rc, dec, prompt, kv_k, kv_v, xk, xv, base_mask, init_mask,
        t_real_d, token_nosp, seek, seek_end, n_max=n_max, reads=reads,
        max_tokens=max_tokens, single_segment=single_segment,
        no_timestamps=no_timestamps, stub=stub, mega=mega, grammar=grammar)


def pack_segment_result(res: SegmentResult) -> torch.Tensor:
    """Flatten the result into ONE f32 tensor so the host pays a single
    device->host read (all values are exactly representable)."""
    f = lambda x: x.float().reshape(-1)
    scalars = torch.cat([f(res.n_tokens), f(res.result_len), f(res.seek_delta),
                         f(res.has_ts), f(res.completed), f(res.failed),
                         f(res.sum_logprobs_all), f(res.no_speech_prob)])
    return torch.cat([f(res.tokens), res.p, res.plog, res.pt, res.ptsum,
                      f(res.tid), scalars])


def unpack_segment_result(flat: np.ndarray, n_max: int) -> dict:
    """Inverse of pack_segment_result -> dict of numpy arrays/scalars."""
    flat = np.asarray(flat)
    f = lambda i: flat[i * n_max:(i + 1) * n_max]
    s = flat[6 * n_max:]
    return dict(
        tokens=f(0).astype(np.int64), p=f(1), plog=f(2), pt=f(3), ptsum=f(4),
        tid=f(5).astype(np.int64), n_tokens=int(s[0]), result_len=int(s[1]),
        seek_delta=int(s[2]), has_ts=bool(s[3]), completed=bool(s[4]),
        failed=bool(s[5]), sum_logprobs_all=float(s[6]),
        no_speech_prob=float(s[7]))
