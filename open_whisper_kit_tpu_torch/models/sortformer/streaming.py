"""AOSC streaming state machine + diarization drivers.

Port of open_whisper_kit_tpu/models/sortformer/streaming.py, itself a port
of the reference's streaming logic (streaming-sortformer/src/sortformer.cpp):
* stream_config defaults (:1673-1690) and latency presets (sortformer.h:137-202),
* spkcache/FIFO state with mean-silence embedding (:1705-1752),
* compress_spkcache -- log-odds importance scores, non-speech disabling,
  latest-frame boost, strong/weak top-K boosts, silence padding, top-K gather
  preserving frame order (:1784-1920),
* the chunked batch driver sortformer_diarize (:2271-2571) and the true
  streaming API (:2676-3281).

The per-chunk compute (pre-encoder + [prefix|chunk] assembly + conformer /
transformer head) runs on the model's device and returns one packed f32
buffer, read once per chunk (`_fused_chunk`). The AOSC (arrival-order
speaker cache) state machine stays small host-side numpy, the JAX package's
code as it stands: numpy's argpartition picks the top-Ks, so the host loop
equals the JAX package's host loop on equal inputs. The mel stays on the
device. `SortformerDiarizer.reads` counts every device-to-host read.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...decode.device_loop import HostReads
from . import model as SM

N_SPK = 4


@dataclasses.dataclass
class StreamConfig:
    chunk_len: int = 188
    fifo_len: int = 0
    spkcache_len: int = 188
    spkcache_update_period: int = 188
    chunk_left_context: int = 1
    chunk_right_context: int = 1
    spkcache_sil_frames_per_spk: int = 3
    sil_threshold: float = 0.2
    pred_score_threshold: float = 0.25
    scores_boost_latest: float = 0.05
    strong_boost_rate: float = 0.75
    weak_boost_rate: float = 1.5
    min_pos_scores_rate: float = 0.5
    max_index: int = 99999


# latency presets (streaming-sortformer/src/sortformer.h:137-202)
PRESETS = {
    "low_latency": StreamConfig(chunk_len=6, fifo_len=188,
                                spkcache_update_period=144,
                                chunk_right_context=7),
    "2s": StreamConfig(chunk_len=15, fifo_len=188,
                       spkcache_update_period=144, chunk_right_context=10),
    "3s": StreamConfig(chunk_len=30, fifo_len=188,
                       spkcache_update_period=144, chunk_right_context=7),
    "5s": StreamConfig(chunk_len=55, fifo_len=188,
                       spkcache_update_period=144, chunk_right_context=7),
    "offline": StreamConfig(),
}


class StreamState:
    """spkcache + FIFO + silence profile, in host numpy."""

    def __init__(self, d_model: int):
        self.d_model = d_model
        self.spkcache = np.zeros((0, d_model), np.float32)
        self.spkcache_preds = np.zeros((0, N_SPK), np.float32)
        self.spkcache_preds_valid = False
        self.fifo = np.zeros((0, d_model), np.float32)
        self.fifo_preds = np.zeros((0, N_SPK), np.float32)
        self.mean_sil_emb = np.zeros(d_model, np.float32)
        self.n_sil_frames = 0

    @property
    def spkcache_len(self) -> int:
        return self.spkcache.shape[0]

    @property
    def fifo_len(self) -> int:
        return self.fifo.shape[0]


def update_silence_profile(st: StreamState, cfg: StreamConfig,
                           pop_embs: np.ndarray, pop_preds: np.ndarray):
    """Running mean of embeddings whose summed preds < sil_threshold."""
    for t in range(pop_embs.shape[0]):
        if pop_preds[t].sum() < cfg.sil_threshold:
            st.n_sil_frames += 1
            w_new = 1.0 / st.n_sil_frames
            st.mean_sil_emb = (1.0 - w_new) * st.mean_sil_emb + w_new * pop_embs[t]


def _boost_topk(scores: np.ndarray, k_per_spk: int, scale: float, offset: float):
    """In-place top-K boost per speaker (sortformer.cpp:1755-1781)."""
    n_frames = scores.shape[0]
    if k_per_spk <= 0 or k_per_spk > n_frames:
        return
    boost = -scale * math.log(offset)
    for s in range(scores.shape[1]):
        col = scores[:, s]
        idx = np.argpartition(-col, k_per_spk - 1)[:k_per_spk]
        scores[idx, s] += boost   # -inf + finite stays -inf


def compress_spkcache(st: StreamState, cfg: StreamConfig):
    """Compress the speaker cache to cfg.spkcache_len frames
    (sortformer.cpp:1784-1920)."""
    n_frames = st.spkcache_len
    target = cfg.spkcache_len
    per_spk = target // N_SPK - cfg.spkcache_sil_frames_per_spk
    strong_k = int(per_spk * cfg.strong_boost_rate)
    weak_k = min(int(per_spk * cfg.weak_boost_rate), n_frames)
    min_pos_k = int(per_spk * cfg.min_pos_scores_rate)

    p = st.spkcache_preds
    thr = cfg.pred_score_threshold
    log_1_sum = np.log(np.maximum(1.0 - p, thr)).sum(axis=1, keepdims=True)
    lp = np.log(np.maximum(p, thr))
    l1p = np.log(np.maximum(1.0 - p, thr))
    scores = lp - l1p + log_1_sum - math.log(0.5)

    scores[p <= 0.5] = -np.inf

    for s in range(N_SPK):
        pos_cnt = int((scores[:, s] > 0).sum())
        if pos_cnt >= min_pos_k:
            kill = (scores[:, s] <= 0) & (p[:, s] > 0.5)
            scores[kill, s] = -np.inf

    if cfg.scores_boost_latest > 0 and n_frames > target:
        latest = scores[target:]
        latest[np.isfinite(latest)] += cfg.scores_boost_latest

    _boost_topk(scores, strong_k, 2.0, 0.5)
    _boost_topk(scores, weak_k, 1.0, 0.5)

    n_sil_pad = cfg.spkcache_sil_frames_per_spk
    n_total = n_frames + n_sil_pad
    scores_full = np.concatenate(
        [scores, np.full((n_sil_pad, N_SPK), np.inf, np.float32)])

    # flatten speaker-major (NeMo permute(0,2,1).reshape)
    flat = scores_full.T.reshape(-1)   # index = s * n_total + t
    order = np.argpartition(-flat, target - 1)[:target]

    topk = np.where(np.isneginf(flat[order]), cfg.max_index, order)
    topk = np.sort(topk)

    n_frames_no_sil = n_total - n_sil_pad
    new_embs = np.empty((target, st.d_model), np.float32)
    new_preds = np.empty((target, N_SPK), np.float32)
    for i in range(target):
        idx = int(topk[i])
        disabled = idx == cfg.max_index
        t = idx % n_total
        if t >= n_frames_no_sil:
            disabled = True
        if disabled:
            new_embs[i] = st.mean_sil_emb
            new_preds[i] = 0.0
        else:
            new_embs[i] = st.spkcache[t]
            new_preds[i] = st.spkcache_preds[t]

    st.spkcache = new_embs
    st.spkcache_preds = new_preds


def _state_update(st: StreamState, cfg: StreamConfig,
                  chunk_embs: np.ndarray, chunk_preds: np.ndarray,
                  full_preds: np.ndarray):
    """FIFO append / pop / spkcache update for one chunk
    (sortformer.cpp:2437-2530)."""
    old_sc_len = st.spkcache_len
    old_fifo_len = st.fifo_len

    if old_fifo_len > 0:
        st.fifo_preds = full_preds[old_sc_len:old_sc_len + old_fifo_len].copy()
    else:
        st.fifo_preds = np.zeros((0, N_SPK), np.float32)

    upd_fifo = np.concatenate([st.fifo, chunk_embs])
    upd_preds = np.concatenate([st.fifo_preds, chunk_preds])
    new_total = upd_fifo.shape[0]

    if new_total > cfg.fifo_len:
        pop = cfg.spkcache_update_period
        pop = max(pop, chunk_embs.shape[0] - cfg.fifo_len + old_fifo_len)
        pop = min(pop, new_total)

        pop_embs = upd_fifo[:pop]
        pop_preds = upd_preds[:pop]
        update_silence_profile(st, cfg, pop_embs, pop_preds)

        st.fifo = upd_fifo[pop:].copy()
        st.fifo_preds = upd_preds[pop:].copy()

        new_sc_len = old_sc_len + pop
        st.spkcache = np.concatenate([st.spkcache, pop_embs])
        if st.spkcache_preds_valid:
            st.spkcache_preds = np.concatenate([st.spkcache_preds, pop_preds])

        if new_sc_len > cfg.spkcache_len:
            if not st.spkcache_preds_valid:
                st.spkcache_preds = np.concatenate(
                    [full_preds[:old_sc_len], pop_preds])
                st.spkcache_preds_valid = True
            compress_spkcache(st, cfg)
    else:
        st.fifo = upd_fifo
        st.fifo_preds = upd_preds


def _pad_rows(x: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """Zero-pad `x` along `dim` to `rows` rows."""
    n = x.shape[dim]
    if n >= rows:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, rows - n]
    return F.pad(x, pad)


def _bucket(n: int, b: int) -> int:
    return -(-n // b) * b


def fused_chunk(cfg: SM.SortformerConfig, params: SM.Params,
                mel_pad: torch.Tensor, t_mel: int, prefix: torch.Tensor,
                p_len: int, n_valid: int) -> torch.Tensor:
    """preencode + [prefix|preenc] assembly + head, ONE packed f32 result.

    mel_pad (1, Tm_pad, n_mels); prefix (P_pad, d_model) is the host's
    concat(spkcache, fifo) zero-padded to a bucket, p_len its live length.
    combined = [prefix[:p_len] | preenc | zeros] (the rows past n_valid are
    masked, so their content does not reach the live rows)."""
    pre = SM.preencode(cfg, params, mel_pad, t_mel)[0]      # (Kp, d)
    P = prefix.shape[0]
    combined = torch.cat([prefix[:p_len].to(torch.float32), pre.float(),
                          prefix.new_zeros(P - p_len, prefix.shape[1])])
    preds = SM.head(cfg, params, combined[None], n_valid)[0]   # (T, n_spk)
    return torch.cat([pre.float().reshape(-1), preds.reshape(-1)])


class SortformerDiarizer:
    """Batch + streaming diarization over the model's compute stages, on
    the device that holds the params."""

    def __init__(self, cfg: SM.SortformerConfig, params: SM.Params):
        self.cfg = cfg
        self.params = params
        self.device = params["mel_fb"].device
        self.reads = HostReads()

    @classmethod
    def from_file(cls, path: str, dtype: torch.dtype = torch.float32, *,
                  device: str | torch.device) -> "SortformerDiarizer":
        from ...io.gguf import load_gguf
        cfg, params = SM.params_from_gguf(load_gguf(path), dtype=dtype,
                                          device=device)
        return cls(cfg, params)

    _BUCKET = 64  # frame bucket: bounds the distinct head/preenc shapes

    def _prefix(self, prefix: np.ndarray, p_pad: int) -> torch.Tensor:
        buf = np.zeros((p_pad, self.cfg.d_model), np.float32)
        buf[:prefix.shape[0]] = prefix
        return torch.from_numpy(buf).to(self.device)

    def _chunk_predict(self, combined: np.ndarray) -> np.ndarray:
        t = combined.shape[0]
        x = self._prefix(combined, _bucket(t, self._BUCKET))
        preds = SM.head(self.cfg, self.params, x[None], t)
        return self.reads.fetch(preds[0])[:t]

    def _preencode(self, chunk_mel: torch.Tensor) -> np.ndarray:
        t = chunk_mel.shape[0]
        mel = _pad_rows(chunk_mel, _bucket(t, self._BUCKET * self.cfg.subsampling))
        out = SM.preencode(self.cfg, self.params, mel[None], t)
        return self.reads.fetch(out[0].float())[:SM.preenc_out_len(t)]

    def _fused_chunk(self, chunk_mel: torch.Tensor, prefix: np.ndarray):
        """One device call + one read for a streaming chunk.

        chunk_mel (t, n_mels) on the device. Returns (preenc (pre_len, d),
        full_preds (p_len + pre_len, n_spk)), equal to _preencode + host
        concat + _chunk_predict on the live rows."""
        t = chunk_mel.shape[0]
        t_pad = _bucket(t, self._BUCKET * self.cfg.subsampling)
        mel = _pad_rows(chunk_mel, t_pad)
        pre_len = SM.preenc_out_len(t)
        p_len = prefix.shape[0]
        p_pad = max(self._BUCKET, _bucket(p_len, self._BUCKET))
        packed = self.reads.fetch(fused_chunk(
            self.cfg, self.params, mel[None], t, self._prefix(prefix, p_pad),
            p_len, p_len + pre_len))
        kp = t_pad // self.cfg.subsampling
        d = self.cfg.d_model
        pre = packed[:kp * d].reshape(kp, d)[:pre_len]
        preds = packed[kp * d:].reshape(p_pad + kp, N_SPK)[:p_len + pre_len]
        return pre, preds

    def diarize(self, samples: np.ndarray,
                stream_cfg: StreamConfig | None = None,
                progress_callback=None,
                device_state: bool = False) -> np.ndarray:
        """16 kHz mono f32 -> per-80ms-frame speaker probs (n_frames, 4).

        Port of sortformer_diarize (sortformer.cpp:2271-2571).

        `device_state=True` runs the ENTIRE chunk loop (incl. the AOSC
        state machine) on the device (device_aosc.py), issued from the
        host's chunk schedule with one read per file instead of one per
        chunk; equal to this host loop up to float associativity. No
        progress_callback in that mode.
        """
        if device_state:
            from .device_aosc import diarize_device
            return diarize_device(self, samples, stream_cfg)
        cfg = self.cfg
        scfg = stream_cfg or StreamConfig()
        sub = cfg.subsampling

        mel, seq_len = SM.compute_mel(cfg, self.params, samples)   # stays on the device
        feat_len = seq_len

        st = StreamState(cfg.d_model)
        total_preds: list[np.ndarray] = []

        stt_feat = 0
        while stt_feat < feat_len:
            end_feat = min(stt_feat + scfg.chunk_len * sub, feat_len)
            left_off = min(scfg.chunk_left_context * sub, stt_feat)
            right_off = min(scfg.chunk_right_context * sub, feat_len - end_feat)

            chunk_mel = mel[stt_feat - left_off:end_feat + right_off]
            lc = round(left_off / sub)
            rc = math.ceil(right_off / sub)

            prefix = np.concatenate([st.spkcache, st.fifo])
            preenc, full_preds = self._fused_chunk(chunk_mel, prefix)
            chunk_used = preenc.shape[0] - lc - rc

            pred_start = st.spkcache_len + st.fifo_len + lc
            chunk_preds = full_preds[pred_start:pred_start + chunk_used]
            total_preds.append(chunk_preds)

            chunk_embs = preenc[lc:lc + chunk_used]
            _state_update(st, scfg, chunk_embs, chunk_preds.copy(), full_preds)

            stt_feat = end_feat
            if progress_callback:
                progress_callback(min(100, 100 * stt_feat // max(1, feat_len)))

        if not total_preds:
            return np.zeros((0, N_SPK), np.float32)
        return np.concatenate(total_preds)

    def diarize_batch(self, audios: list[np.ndarray],
                      stream_cfg: StreamConfig | None = None,
                      device_state: bool = False) -> list[np.ndarray]:
        """Diarize several files in lockstep: each chunk round runs ONE
        batched pre-encoder + head call over all files (the AOSC schedule is
        shape-deterministic, so per-file states stay aligned).

        Equal-length files match per-file diarization exactly. Shorter files
        ride along on zero-padded mel (their chunk schedule follows the batch
        maximum), so their predictions are those of the zero-padded audio --
        near-identical in practice; batch same-length files when exactness
        matters. `device_state=True`: the whole loop on the device, one read
        for the batch (device_aosc.py)."""
        if device_state:
            from .device_aosc import diarize_device_batch
            return diarize_device_batch(self, audios, stream_cfg)
        if not audios:
            return []
        cfg = self.cfg
        scfg = stream_cfg or StreamConfig()
        sub = cfg.subsampling
        Bf = len(audios)

        mels = []
        seq_lens = []
        for a in audios:
            m, s = SM.compute_mel(cfg, self.params, np.asarray(a, np.float32))
            mels.append(m)
            seq_lens.append(s)
        feat_len = max(seq_lens)
        n_mel_rows = max(m.shape[0] for m in mels)
        mel_b = torch.stack([_pad_rows(m, n_mel_rows) for m in mels])

        states = [StreamState(cfg.d_model) for _ in range(Bf)]
        outs: list[list[np.ndarray]] = [[] for _ in range(Bf)]

        stt_feat = 0
        while stt_feat < feat_len:
            end_feat = min(stt_feat + scfg.chunk_len * sub, feat_len)
            left_off = min(scfg.chunk_left_context * sub, stt_feat)
            right_off = min(scfg.chunk_right_context * sub, feat_len - end_feat)

            chunk_mel = mel_b[:, stt_feat - left_off:end_feat + right_off]
            lc = round(left_off / sub)
            rc = math.ceil(right_off / sub)

            t = chunk_mel.shape[1]
            chunk_mel = _pad_rows(chunk_mel, _bucket(t, self._BUCKET * sub), dim=1)
            preenc = self.reads.fetch(SM.preencode(
                cfg, self.params, chunk_mel, t).float())[:, :SM.preenc_out_len(t)]
            chunk_used = preenc.shape[1] - lc - rc

            sc_len = states[0].spkcache_len
            fifo_len = states[0].fifo_len
            combined = np.concatenate([
                np.stack([st.spkcache for st in states]) if sc_len else
                np.zeros((Bf, 0, cfg.d_model), np.float32),
                np.stack([st.fifo for st in states]) if fifo_len else
                np.zeros((Bf, 0, cfg.d_model), np.float32),
                preenc], axis=1)

            tt = combined.shape[1]
            x = np.zeros((Bf, _bucket(tt, self._BUCKET), cfg.d_model), np.float32)
            x[:, :tt] = combined
            full_preds = self.reads.fetch(SM.head(
                cfg, self.params, torch.from_numpy(x).to(self.device), tt))[:, :tt]

            pred_start = sc_len + fifo_len + lc
            for i, st in enumerate(states):
                chunk_preds = full_preds[i, pred_start:pred_start + chunk_used]
                outs[i].append(chunk_preds)
                chunk_embs = preenc[i, lc:lc + chunk_used]
                _state_update(st, scfg, chunk_embs, chunk_preds.copy(),
                              full_preds[i])

            stt_feat = end_feat

        results = []
        for i in range(Bf):
            probs = (np.concatenate(outs[i]) if outs[i]
                     else np.zeros((0, N_SPK), np.float32))
            n_true = -(-seq_lens[i] // sub)
            results.append(probs[:n_true])
        return results


class SortformerStream:
    """True streaming API: feed arbitrary sample counts, poll frame probs.

    Port of sortformer_stream_* (sortformer.cpp:2676-3281): keeps an audio
    remainder so mel frames align to hop boundaries, accumulates mel until a
    full chunk (+right context) is available, then advances the AOSC state.
    Each chunk reads the device once (its predictions; on the host path the
    packed chunk result)."""

    def __init__(self, diarizer: SortformerDiarizer,
                 preset: str | StreamConfig = "low_latency",
                 device_state: bool = False):
        """`device_state=True` keeps the AOSC state (spkcache/FIFO/silence
        profile) resident on the device and advances it per chunk
        (device_aosc.stream_step); the host reads only the (chunk, 4)
        predictions. Equal to the host state machine up to float
        associativity of the silence-profile mean."""
        self.d = diarizer
        self.cfg = diarizer.cfg
        self.scfg = (PRESETS[preset] if isinstance(preset, str)
                     else preset)
        self.st = StreamState(self.cfg.d_model)
        self._audio = np.zeros(0, np.float32)
        self._out: list[np.ndarray] = []
        self.n_chunks = 0
        self.device_state = device_state
        if device_state:
            from . import device_aosc as DA
            DA._check_scfg(self.scfg)
            sub = self.cfg.subsampling
            bucket = 64 * sub
            need_feat = (self.scfg.chunk_len
                         + self.scfg.chunk_right_context) * sub
            self._mel_max = max(_bucket(need_feat, bucket), bucket)
            self._ch_max = SM.preenc_out_len(self._mel_max)
            t_comb_raw = (self.scfg.spkcache_len + self.scfg.fifo_len
                          + self._mel_max // sub)
            self._t_comb = _bucket(t_comb_raw, 64)
            self._dev_state = DA.init_state_dev(self.scfg, self.cfg.d_model,
                                                self._ch_max, device=diarizer.device)

    def feed(self, samples: np.ndarray):
        """Append audio; runs chunks as they fill."""
        self._audio = np.concatenate(
            [self._audio, np.asarray(samples, np.float32)])
        self._process(final=False)

    def finish(self):
        """Flush remaining audio (right context padded with silence)."""
        self._process(final=True)

    def _process(self, final: bool):
        cfg, scfg, sub = self.cfg, self.scfg, self.cfg.subsampling
        hop = cfg.hop_length
        # mel frames available from buffered audio (need n_fft window)
        n = len(self._audio)
        chunk_feat = scfg.chunk_len * sub
        need_feat = chunk_feat + scfg.chunk_right_context * sub

        while True:
            avail_feat = n // hop
            if avail_feat < need_feat and not final:
                return
            if avail_feat <= 0:
                return
            take_feat = min(chunk_feat, avail_feat)
            # compute mel over the whole remaining buffer each round
            mel, seq_len = SM.compute_mel(cfg, self.d.params, self._audio)

            end_feat = min(take_feat, seq_len)
            right_off = min(scfg.chunk_right_context * sub, seq_len - end_feat)
            chunk_mel = mel[:end_feat + right_off]
            if chunk_mel.shape[0] == 0:
                return
            rc = math.ceil(right_off / sub)

            if self.device_state:
                from . import device_aosc as DA
                t_mel = chunk_mel.shape[0]
                chunk_used = SM.preenc_out_len(t_mel) - rc
                if chunk_used <= 0:
                    return
                self._dev_state, preds = DA.stream_step(
                    self.cfg, scfg, self.d.params, self._dev_state,
                    _pad_rows(chunk_mel, self._mel_max), t_mel, chunk_used,
                    self._ch_max, self._t_comb)
                self._out.append(self.d.reads.fetch(preds)[:chunk_used])
            else:
                st = self.st
                prefix = np.concatenate([st.spkcache, st.fifo])
                preenc, full_preds = self.d._fused_chunk(chunk_mel, prefix)
                chunk_used = preenc.shape[0] - rc
                if chunk_used <= 0:
                    return
                pred_start = st.spkcache_len + st.fifo_len
                chunk_preds = full_preds[pred_start:pred_start + chunk_used]
                self._out.append(chunk_preds.copy())

                chunk_embs = preenc[:chunk_used]
                _state_update(st, scfg, chunk_embs, chunk_preds.copy(),
                              full_preds)
            self.n_chunks += 1

            consumed = end_feat * hop
            self._audio = self._audio[consumed:]
            n = len(self._audio)
            if final and n < hop:
                return
            if not final and n // hop < need_feat:
                return

    def probs(self) -> np.ndarray:
        if not self._out:
            return np.zeros((0, N_SPK), np.float32)
        return np.concatenate(self._out)
