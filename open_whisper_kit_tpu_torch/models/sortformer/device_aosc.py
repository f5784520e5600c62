"""Device-resident AOSC: the whole streaming diarization loop on the device,
one host read per file.

Port of open_whisper_kit_tpu/models/sortformer/device_aosc.py. The host
loop in streaming.py mirrors the reference chunk-by-chunk
(sortformer.cpp:2271-2571 + 1655-1920) and reads the device once per
chunk. This module re-expresses the same state machine on fixed-shape
device tensors, so a file's chunks are issued back to back and read once:

* spkcache/FIFO live in padded buffers with their lengths held as device
  tensors; the "concat" steps become boundary gathers,
* compress_spkcache's argpartition top-Ks become a stable descending sort,
  which puts the lower index first among equal values as the JAX side's
  lax.top_k does (torch.topk promises no order); +inf silence pads and
  -inf disabled frames behave identically,
* the silence profile's running mean is computed in closed form
  (mathematically equal to the reference's sequential update; floating
  point may differ in the last ulps),
* the JAX side's lax.cond branches (pop or not, compress or not) are both
  computed and selected per file, since the lengths stay on the device.

Every state tensor has a leading file axis (the JAX side's vmap). The chunk
schedule (mel offsets, context sizes, live rows) is known to the host in
advance, so the JAX side's lax.scan is a Python loop issuing each chunk.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model as SM
from .streaming import N_SPK, StreamConfig, _bucket, _pad_rows

_NEG = float("-inf")


def _gather_rows(buf: torch.Tensor, offset, idx: torch.Tensor) -> torch.Tensor:
    """buf (B, N, C); rows clip(idx + offset) with offset an int or a (B,)
    tensor -> (B, M, C)."""
    if isinstance(offset, torch.Tensor):
        ii = idx[None, :] + offset[:, None]
    else:
        ii = (idx + offset)[None, :]
    ii = ii.clamp(0, buf.shape[1] - 1)
    return torch.take_along_dim(buf, ii[..., None], dim=1)


def _rows(mask: torch.Tensor) -> torch.Tensor:
    """(B, M) row mask -> (B, M, 1) for selecting whole rows."""
    return mask[..., None]


def _topk_index(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Indices of the k largest along `dim`, the lower index first among
    equal values (jax.lax.top_k's order)."""
    return torch.sort(x, dim=dim, descending=True, stable=True).indices.narrow(dim, 0, k)


def _boost_topk_dev(scores: torch.Tensor, k: int, scale: float, offset: float,
                    live: torch.Tensor) -> torch.Tensor:
    """Per-speaker top-K boost (streaming.py _boost_topk, device form);
    scores (B, N, N_SPK), live (B, N)."""
    if k <= 0:
        return scores
    boost = -scale * math.log(offset)
    col = torch.where(_rows(live), scores, _NEG)
    idx = _topk_index(col, k, dim=1)                      # (B, k, N_SPK)
    add = torch.zeros_like(scores).scatter_add_(
        1, idx, torch.full(idx.shape, boost, dtype=scores.dtype, device=scores.device))
    return scores + add   # -inf + finite stays -inf


def _compress_dev(sc, sc_preds, sc_len, sil_emb, scfg: StreamConfig):
    """compress_spkcache on fixed-shape buffers (streaming.py:compress);
    sc (B, SC_MAX, d), sc_preds (B, SC_MAX, N_SPK), sc_len (B,), sil_emb
    (B, d)."""
    B, SC_MAX = sc.shape[:2]
    dev = sc.device
    target = scfg.spkcache_len
    per_spk = target // N_SPK - scfg.spkcache_sil_frames_per_spk
    strong_k = int(per_spk * scfg.strong_boost_rate)
    # compress only triggers at sc_len > target >= these Ks (driver asserts)
    weak_k = int(per_spk * scfg.weak_boost_rate)
    min_pos_k = int(per_spk * scfg.min_pos_scores_rate)
    n_sil_pad = scfg.spkcache_sil_frames_per_spk
    thr = scfg.pred_score_threshold

    i = torch.arange(SC_MAX, device=dev)
    live = i[None, :] < sc_len[:, None]                   # (B, SC_MAX)
    p = sc_preds
    log_1_sum = torch.log(torch.clamp_min(1.0 - p, thr)).sum(dim=-1, keepdim=True)
    scores = (torch.log(torch.clamp_min(p, thr)) - torch.log(torch.clamp_min(1.0 - p, thr))
              + log_1_sum - math.log(0.5))
    scores = torch.where(p <= 0.5, _NEG, scores)
    scores = torch.where(_rows(live), scores, _NEG)

    # disable weak positives when enough strong ones exist
    pos_cnt = ((scores > 0) & _rows(live)).sum(dim=1, keepdim=True)   # (B, 1, N_SPK)
    kill = (scores <= 0) & (p > 0.5) & _rows(live)
    scores = torch.where((pos_cnt >= min_pos_k) & kill, _NEG, scores)

    if scfg.scores_boost_latest > 0:
        latest = (i[None, :] >= target) & live
        scores = torch.where(_rows(latest) & torch.isfinite(scores),
                             scores + scfg.scores_boost_latest, scores)

    scores = _boost_topk_dev(scores, strong_k, 2.0, 0.5, live)
    scores = _boost_topk_dev(scores, weak_k, 1.0, 0.5, live)

    # speaker-major flat scores over R = SC_MAX + n_sil_pad rows per speaker:
    # rows [0, sc_len) live, [sc_len, sc_len+n_sil_pad) = +inf silence pads,
    # the rest -inf. Index s*R + t preserves the reference's (s, t) ordering.
    R = SC_MAX + n_sil_pad
    t_idx = torch.arange(R, device=dev)[None, :]
    n = sc_len[:, None]
    base = torch.where(_rows(t_idx < n),
                       _gather_rows(scores, 0, torch.arange(R, device=dev)), _NEG)
    pads = (t_idx >= n) & (t_idx < n + n_sil_pad)
    cols = torch.where(_rows(pads), float("inf"), base)   # (B, R, N_SPK)
    flat = cols.transpose(1, 2).reshape(B, N_SPK * R)

    order = _topk_index(flat, target, dim=1)              # (B, target)
    vals = torch.gather(flat, 1, order)
    BIG = 4 * R + 1
    key_sorted = torch.where(torch.isneginf(vals), BIG, order).sort(dim=1).values
    t = key_sorted % R
    disabled = (key_sorted == BIG) | (t >= n)
    t_safe = t.clamp(0, SC_MAX - 1)
    new_embs = torch.where(_rows(disabled), sil_emb[:, None, :],
                           torch.take_along_dim(sc, t_safe[..., None], dim=1))
    new_preds = torch.where(_rows(disabled), 0.0,
                            torch.take_along_dim(sc_preds, t_safe[..., None], dim=1))

    sc_out = torch.zeros_like(sc)
    sc_out[:, :target] = new_embs
    scp_out = torch.zeros_like(sc_preds)
    scp_out[:, :target] = new_preds
    return sc_out, scp_out, torch.full_like(sc_len, target)


def _state_update_dev(state: dict, scfg: StreamConfig, chunk_embs, chunk_used: int,
                      chunk_preds, full_preds) -> dict:
    """_state_update on fixed-shape buffers (streaming.py:_state_update)."""
    B, F_MAX = state["fifo"].shape[:2]
    CH_MAX = chunk_embs.shape[1]
    U_MAX = F_MAX + CH_MAX
    SC_MAX = state["sc"].shape[1]
    dev = chunk_embs.device

    sc_len = state["sc_len"]
    fifo_len = state["fifo_len"]

    # refresh fifo preds from this round's full predictions
    fi = torch.arange(F_MAX, device=dev)
    fifo_live = fi[None, :] < fifo_len[:, None]
    fifo_preds = torch.where(_rows(fifo_live), _gather_rows(full_preds, sc_len, fi), 0.0)

    # upd = [fifo | chunk]
    ui = torch.arange(U_MAX, device=dev)
    from_fifo = _rows(ui[None, :] < fifo_len[:, None])
    ui_f = ui.clamp(0, F_MAX - 1)
    upd = torch.where(from_fifo, _gather_rows(state["fifo"], 0, ui_f),
                      _gather_rows(chunk_embs, -fifo_len, ui))
    upd_preds = torch.where(from_fifo, _gather_rows(fifo_preds, 0, ui_f),
                            _gather_rows(chunk_preds, -fifo_len, ui))
    new_total = fifo_len + chunk_used
    upd_live = _rows(ui[None, :] < new_total[:, None])
    upd = torch.where(upd_live, upd, 0.0)
    upd_preds = torch.where(upd_live, upd_preds, 0.0)

    no_pop = dict(state, fifo=upd[:, :F_MAX], fifo_preds=upd_preds[:, :F_MAX],
                  fifo_len=new_total)

    # the pop branch
    pop = torch.clamp_min(chunk_used - scfg.fifo_len + fifo_len,
                          scfg.spkcache_update_period)
    pop = torch.minimum(pop, new_total)

    # silence profile (closed-form running mean)
    sel = (ui[None, :] < pop[:, None]) & (upd_preds.sum(dim=-1) < scfg.sil_threshold)
    cnt = sel.sum(dim=1)
    ssum = (upd * _rows(sel)).sum(dim=1)
    n_sil = state["n_sil"]
    n_new = n_sil + cnt
    mean = torch.where((n_new > 0)[:, None],
                       (state["sil_emb"] * n_sil[:, None] + ssum)
                       / torch.clamp_min(n_new, 1)[:, None],
                       state["sil_emb"])

    fifo_new_len = new_total - pop
    keep = _rows(fi[None, :] < fifo_new_len[:, None])
    fifo_new = torch.where(keep, _gather_rows(upd, pop, fi), 0.0)
    fifo_preds_new = torch.where(keep, _gather_rows(upd_preds, pop, fi), 0.0)

    si = torch.arange(SC_MAX, device=dev)
    new_sc_len = sc_len + pop
    old = _rows(si[None, :] < sc_len[:, None])
    new = _rows(si[None, :] < new_sc_len[:, None])
    sc_new = torch.where(old, state["sc"],
                         torch.where(new, _gather_rows(upd, -sc_len, si), 0.0))
    # preds: existing when valid, else re-seeded from full_preds
    base_preds = torch.where(state["sc_preds_valid"][:, None, None], state["sc_preds"],
                             torch.where(old, _gather_rows(full_preds, 0, si), 0.0))
    sc_preds_new = torch.where(old, base_preds,
                               torch.where(new, _gather_rows(upd_preds, -sc_len, si), 0.0))

    do = new_sc_len > scfg.spkcache_len
    sc_c, scp_c, len_c = _compress_dev(sc_new, sc_preds_new, new_sc_len, mean, scfg)
    popped = dict(state,
                  sc=torch.where(do[:, None, None], sc_c, sc_new),
                  sc_preds=torch.where(do[:, None, None], scp_c, sc_preds_new),
                  sc_len=torch.where(do, len_c, new_sc_len),
                  sc_preds_valid=state["sc_preds_valid"] | do,
                  fifo=fifo_new, fifo_preds=fifo_preds_new,
                  fifo_len=fifo_new_len, sil_emb=mean, n_sil=n_new)

    take = new_total > scfg.fifo_len                      # (B,)
    out = {}
    for k, v in popped.items():
        m = take.reshape((B,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, v, no_pop[k])
    return out


def init_state_dev(scfg: StreamConfig, d_model: int, ch_max: int, *,
                   batch: int = 1, device: str | torch.device) -> dict:
    SC_MAX = scfg.spkcache_len + scfg.fifo_len + ch_max
    F_MAX = scfg.fifo_len + ch_max

    def z(*shape, dtype=torch.float32):
        return torch.zeros((batch,) + shape, dtype=dtype, device=device)
    return {
        "sc": z(SC_MAX, d_model),
        "sc_preds": z(SC_MAX, N_SPK),
        "sc_len": z(dtype=torch.int64),
        "sc_preds_valid": z(dtype=torch.bool),
        "fifo": z(F_MAX, d_model),
        "fifo_preds": z(F_MAX, N_SPK),
        "fifo_len": z(dtype=torch.int64),
        "sil_emb": z(d_model),
        "n_sil": z(dtype=torch.int64),
    }


def _chunk_step(cfg, scfg: StreamConfig, params, state: dict, chunk_mel, t_mel: int,
                lc: int, chunk_used: int, ch_max: int, t_comb: int):
    """One streaming chunk for B files: preencode + [spkcache|fifo|chunk]
    assembly + head + AOSC state update, on fixed-shape device buffers.
    chunk_mel (B, mel_max, n_mels); t_mel, lc and chunk_used come from the
    host's schedule. Shared by the whole-file loop below and the
    true-streaming step (stream_step)."""
    dev = chunk_mel.device
    pre = SM.preencode(cfg, params, chunk_mel, t_mel).float()   # (B, Kp, d)
    pre_len = SM.preenc_out_len(t_mel)

    sc_len, fifo_len = state["sc_len"], state["fifo_len"]
    p_len = sc_len + fifo_len
    ci = torch.arange(t_comb, device=dev)
    from_sc = _rows(ci[None, :] < sc_len[:, None])
    from_fifo = (~from_sc) & _rows(ci[None, :] < p_len[:, None])
    combined = torch.where(
        from_sc, _gather_rows(state["sc"], 0, ci.clamp(0, state["sc"].shape[1] - 1)),
        torch.where(from_fifo, _gather_rows(state["fifo"], -sc_len, ci),
                    _gather_rows(pre, -p_len, ci)))
    full_preds = SM.head(cfg, params, combined, p_len + pre_len)   # (B, t_comb, 4)

    oi = torch.arange(ch_max, device=dev)
    live = _rows((oi < chunk_used)[None, :])
    chunk_preds = torch.where(live, _gather_rows(full_preds, p_len + lc, oi), 0.0)
    chunk_embs = torch.where(live, _gather_rows(pre, lc, oi), 0.0)

    state = _state_update_dev(state, scfg, chunk_embs, chunk_used,
                              chunk_preds, full_preds)
    return state, chunk_preds


def stream_step(cfg, scfg: StreamConfig, params, state: dict, chunk_mel,
                t_mel: int, chunk_used: int, ch_max: int, t_comb: int):
    """True-streaming single-chunk step with device-resident AOSC state.

    chunk_mel (mel_max, n_mels) zero-padded. Returns (new state, (ch_max, 4)
    chunk predictions -- the only per-chunk read, which the caller makes)."""
    state, preds = _chunk_step(cfg, scfg, params, state, chunk_mel[None], t_mel,
                               0, chunk_used, ch_max, t_comb)
    return state, preds[0]


def _chunk_schedule(cfg, scfg: StreamConfig, feat_len: int):
    sub = cfg.subsampling
    starts, t_mels, lcs, useds = [], [], [], []
    stt = 0
    while stt < feat_len:
        end = min(stt + scfg.chunk_len * sub, feat_len)
        lo = min(scfg.chunk_left_context * sub, stt)
        ro = min(scfg.chunk_right_context * sub, feat_len - end)
        t = (end + ro) - (stt - lo)
        lc = round(lo / sub)
        rc = math.ceil(ro / sub)
        starts.append(stt - lo)
        t_mels.append(t)
        lcs.append(lc)
        useds.append(SM.preenc_out_len(t) - lc - rc)
        stt = end
    return starts, t_mels, lcs, useds


def _loop_sizes(cfg, scfg, t_mels, useds) -> tuple[int, int, int]:
    bucket = 64 * cfg.subsampling
    mel_max = max(_bucket(max(t_mels), bucket), bucket)
    ch_max = max(useds)
    t_comb = _bucket(scfg.spkcache_len + scfg.fifo_len + mel_max // cfg.subsampling, 64)
    return mel_max, ch_max, t_comb


def _check_scfg(scfg: StreamConfig):
    per_spk = scfg.spkcache_len // N_SPK - scfg.spkcache_sil_frames_per_spk
    assert int(per_spk * scfg.weak_boost_rate) <= scfg.spkcache_len, \
        "device AOSC requires weak_k <= spkcache_len (top-k size is static)"


def _run_loop(diarizer, mels: list[torch.Tensor], seq_lens: list[int],
              scfg: StreamConfig):
    """The chunk loop over B files on the device, then ONE read: the
    per-chunk predictions (B, n_chunks, ch_max, 4), with the schedule's
    live rows per chunk (`useds`)."""
    cfg = diarizer.cfg
    starts, t_mels, lcs, useds = _chunk_schedule(cfg, scfg, max(seq_lens))
    if not starts:
        return None, []
    mel_max, ch_max, t_comb = _loop_sizes(cfg, scfg, t_mels, useds)
    rows = max(max(m.shape[0] for m in mels), starts[-1] + mel_max)
    mel_b = torch.stack([_pad_rows(m, rows) for m in mels])    # padded on the device
    state = init_state_dev(scfg, cfg.d_model, ch_max, batch=len(mels),
                           device=diarizer.device)
    preds = []
    for start, t_mel, lc, used in zip(starts, t_mels, lcs, useds):
        state, p = _chunk_step(cfg, scfg, diarizer.params, state,
                               mel_b[:, start:start + mel_max], t_mel, lc, used,
                               ch_max, t_comb)
        preds.append(p)
    return diarizer.reads.fetch(torch.stack(preds, dim=1)), useds


def diarize_device(diarizer, samples: np.ndarray,
                   scfg: StreamConfig | None = None) -> np.ndarray:
    """One-read diarization (same output as SortformerDiarizer.diarize up
    to float associativity; see module docstring)."""
    scfg = scfg or StreamConfig()
    _check_scfg(scfg)
    mel, seq_len = SM.compute_mel(diarizer.cfg, diarizer.params, samples)
    preds, useds = _run_loop(diarizer, [mel], [int(seq_len)], scfg)
    if preds is None:
        return np.zeros((0, N_SPK), np.float32)
    return np.concatenate([preds[0, i, :u] for i, u in enumerate(useds)])


def diarize_device_batch(diarizer, audios: list[np.ndarray],
                         scfg: StreamConfig | None = None) -> list[np.ndarray]:
    """Batched one-read diarization over several files in lockstep (chunk
    schedule follows the batch maximum -- same semantics as
    SortformerDiarizer.diarize_batch)."""
    if not audios:
        return []
    cfg = diarizer.cfg
    scfg = scfg or StreamConfig()
    _check_scfg(scfg)
    mels, seq_lens = [], []
    for a in audios:
        m, s = SM.compute_mel(cfg, diarizer.params, np.asarray(a, np.float32))
        mels.append(m)
        seq_lens.append(int(s))
    preds, useds = _run_loop(diarizer, mels, seq_lens, scfg)
    if preds is None:
        return [np.zeros((0, N_SPK), np.float32) for _ in audios]
    out = []
    for b, sl in enumerate(seq_lens):
        full = np.concatenate([preds[b, i, :u] for i, u in enumerate(useds)])
        out.append(full[:-(-sl // cfg.subsampling)])
    return out
