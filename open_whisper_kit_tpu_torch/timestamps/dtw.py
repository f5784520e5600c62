"""Token-level timestamps via DTW on cross-attention (the accurate path).

Port of open_whisper_kit_tpu/timestamps/dtw.py: the alignment-head presets,
`heads_for_model`, `median_filter_reflect` and `dtw_backtrace` are copied as
they stand (numpy); `compute_dtw_timestamps` runs its re-decode on the
context's device. It ports whisper_exp_compute_token_level_timestamps_dtw +
dtw_and_backtrace (src/whisper.cpp:8712-8997) and the per-model
alignment-head tables (src/whisper.cpp:384-410):

1. re-decode [sot,(lang),not, text..., eot] collecting softmax cross-attention
   (`decode_impl(collect_cross_qk=True)`), gathering the model's alignment
   heads on the device so the host reads one (n_heads, T, Ta) array,
2. slice to n_frames/2 audio positions, z-normalize across the token dim,
   median-filter (width 7, reflect) over audio frames, mean over heads,
3. DTW + backtrace over the negated matrix; each time-index step = 20 ms.
"""

from __future__ import annotations

import numpy as np

# (text_layer, head) per model preset (src/whisper.cpp:384-396)
ALIGNMENT_HEADS: dict[str, list[tuple[int, int]]] = {
    "tiny.en": [(1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)],
    "tiny": [(2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)],
    "base.en": [(3, 3), (4, 7), (5, 1), (5, 5), (5, 7)],
    "base": [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)],
    "small.en": [(6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0),
                 (9, 4), (9, 8), (9, 10), (10, 0), (10, 1), (10, 2), (10, 3),
                 (10, 6), (10, 11), (11, 2), (11, 4)],
    "small": [(5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)],
    "medium.en": [(11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)],
    "medium": [(13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)],
    "large-v1": [(9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
                 (22, 17), (23, 2), (23, 15)],
    "large-v2": [(10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15),
                 (17, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)],
    "large-v3": [(7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)],
    "large-v3-turbo": [(2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)],
}
ALIGNMENT_HEADS["large"] = ALIGNMENT_HEADS["large-v3"]


def heads_for_model(model_type: str,
                    custom: list[tuple[int, int]] | None = None,
                    n_text_layer: int = 0, n_head: int = 0):
    """Resolve alignment heads: custom > preset > top-half-layers fallback
    (WHISPER_AHEADS_N_TOP_MOST behavior)."""
    if custom:
        return list(custom)
    if model_type in ALIGNMENT_HEADS:
        return ALIGNMENT_HEADS[model_type]
    # fallback: every head of the top half of the text layers
    return [(l, h) for l in range(n_text_layer // 2, n_text_layer)
            for h in range(n_head)]


def median_filter_reflect(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding
    (src/whisper.cpp:8802-8835)."""
    assert width % 2 == 1
    half = width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(half, half)], mode="reflect")
    stacked = np.stack([padded[..., i:i + x.shape[-1]] for i in range(width)],
                       axis=-1)
    return np.median(stacked, axis=-1)


def dtw_backtrace(x: np.ndarray) -> np.ndarray:
    """Monotonic alignment path of cost matrix x (N tokens, M frames)
    -> (2, n_path) [text_idx; time_idx] (src/whisper.cpp:8712-8790)."""
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, np.float32)
    trace = np.full((N + 1, M + 1), -1, np.int32)
    cost[0, 0] = 0.0

    # vectorized anti-diagonal sweep would be nicer; N*M here is ~100*1500,
    # a per-row vectorized scan is fast enough in numpy
    for i in range(1, N + 1):
        row_x = x[i - 1]
        prev = cost[i - 1]
        cur = cost[i]
        tr = trace[i]
        # cur[j] depends on cur[j-1] -> sequential in j, but use C-speed ops
        c_prev_diag = prev[:-1]
        c_prev_up = prev[1:]
        for j in range(1, M + 1):
            c0 = c_prev_diag[j - 1]
            c1 = c_prev_up[j - 1]
            c2 = cur[j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cur[j] = row_x[j - 1] + c
            tr[j] = t

    trace[0, :] = 2
    trace[:, 0] = 1
    path = []
    i, j = N, M
    while i > 0 or j > 0:
        path.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    path.reverse()
    return np.asarray(path, np.int32).T


def compute_dtw_timestamps(ctx, result, i_segment: int, n_segments: int,
                           seek: int, n_frames: int, language: str | None,
                           medfilt_width: int = 7):
    """Fill t_dtw on the tokens of result.segments[i_segment:i_segment+n]
    from the window's cached cross-KV (`result._dtw_encoder_cache`)."""
    import torch

    from ..decode import tokenizer as tok_mod
    from ..models.whisper import model as M

    vocab = ctx.vocab
    cfg = ctx.cfg

    tokens = [vocab.token_sot]
    if vocab.is_multilingual:
        tokens.append(vocab.token_lang(tok_mod.lang_id(language or "en")))
    sot_len = len(tokens)
    tokens.append(vocab.token_not)
    segs = result.segments[i_segment:i_segment + n_segments]
    for seg in segs:
        tokens.extend(t.id for t in seg.tokens if t.id < vocab.token_eot)
    tokens.append(vocab.token_eot)

    # re-decode collecting cross-attention probabilities
    mel_cache = getattr(result, "_dtw_encoder_cache", None)
    if mel_cache is None or mel_cache[0] != seek:
        raise RuntimeError("dtw: encoder output for this window not cached")
    _, xk, xv = mel_cache[1]
    kv_k, kv_v = M.init_kv_cache(cfg, 1, dtype=ctx.dtype, device=ctx.device)
    toks = torch.tensor([tokens], dtype=torch.long, device=ctx.device)
    # the logits are not read: only the last position's are formed
    _, _, _, cross_qk = M.decode_impl(
        cfg, ctx.params["decoder"], toks, kv_k, kv_v, 0, xk, xv,
        logits_pos=len(tokens) - 1, collect_cross_qk=True)
    # cross_qk: (L, 1, H, T, Ta) f32; gather just the alignment heads on
    # the device so only (n_heads, T, Ta) crosses to the host
    heads = heads_for_model(ctx.model_type, n_text_layer=cfg.n_text_layer,
                            n_head=cfg.n_text_head)
    l_idx = torch.tensor([l for l, _ in heads], dtype=torch.long, device=ctx.device)
    h_idx = torch.tensor([h for _, h in heads], dtype=torch.long, device=ctx.device)
    w = ctx.reads.fetch(cross_qk[l_idx, 0, h_idx])     # (n_heads, T, Ta)

    n_audio_tokens = n_frames // 2
    w = w[:, :, :n_audio_tokens]

    # z-normalize across the token dim per (head, frame) — matches
    # openai timing.py std_mean(dim=-2) / reference ggml_norm (whisper.cpp:8930)
    mean = w.mean(axis=1, keepdims=True)
    var = w.var(axis=1, keepdims=True)
    w = (w - mean) / np.sqrt(var + 1e-9)

    w = median_filter_reflect(w, medfilt_width)
    matrix = w.mean(axis=0)                       # (T, n_audio_tokens)
    matrix = -matrix[sot_len:-1]                  # rows: [not] + text tokens

    alignment = dtw_backtrace(matrix.astype(np.float32))

    # place timestamps (src/whisper.cpp:8960-8986)
    flat_tokens = [t for seg in segs for t in seg.tokens]
    text_iter = (t for t in flat_tokens)
    cur_tok = None
    last_v = 0
    for col in range(alignment.shape[1]):
        v = int(alignment[0, col])
        if v != last_v:
            time_index = int(alignment[1, col])
            timestamp = time_index * 2 + seek     # 1 DTW index = 20 ms
            last_v = v
            while True:
                cur_tok = next(text_iter, None)
                if cur_tok is None:
                    return
                if cur_tok.id < vocab.token_eot:
                    break
            cur_tok.t_dtw = timestamp
