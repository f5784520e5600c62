"""Data parallelism over audio chunks (whisper_full_parallel semantics).

Port of open_whisper_kit_tpu/parallel/dp.py (src/whisper.cpp:7801-7929):
split the (optionally VAD-filtered) samples into n chunks, transcribe each
with an independent state, then merge segments with time-offset fixup and
non-overlap clamping. Two routes, as in the JAX package:

1. **Lockstep** (decode/batch.py::transcribe_chunks_with_timings) when the
   params are greedy-t0-compatible: all chunks' windows decode together
   on the device, each chunk with its own mel normalization context; a
   chunk whose QA gates trip re-runs through whisper_full.
2. **Threads** otherwise: one thread per chunk over the shared context
   (the reference's std::thread model), each running whisper_full.

`params.cross_kv_int8` reaches both routes through the params (the JAX
package hands it to the lockstep route as an argument). With `params.vad`
the Silero VAD filters the samples once, up front, on the context's device;
the chunks then run with vad=False, and their segment times stay in the
filtered audio's time, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..decode import full as F
from ..decode.batch import transcribe_chunks_with_timings
from ..decode.params import FullParams, SamplingStrategy

SAMPLE_RATE = 16000


def _batch_route_eligible(ctx: F.WhisperContext, p: FullParams) -> bool:
    """The lockstep pipeline handles greedy t=0, default-context decoding;
    everything it cannot represent is delegated per chunk to whisper_full
    by the QA gates, except features that change the step program."""
    return (p.strategy == SamplingStrategy.GREEDY
            and p.temperature == 0.0
            and not p.vad
            and p.offset_ms == 0       # seeking keeps the skipped prefix in
                                       # the chunk's mel normalization window
            and not p.detect_language
            and p.language != "auto"   # no per-chunk language detection
            and p.no_context
            and not p.token_timestamps
            and not p.dtw_token_timestamps
            and p.grammar_rules is None
            and p.initial_prompt is None
            and p.prompt_tokens is None
            and not p.single_segment
            and p.duration_ms == 0
            and not p.print_progress          # chunk 0 prints live in the
            and not p.print_realtime          # reference's thread model
            and p.logits_filter_callback is None
            and p.encoder_begin_callback is None
            and p.abort_callback is None
            and p.progress_callback is None
            and p.new_segment_callback is None
            and p.use_device_loops)


def full_parallel(ctx: F.WhisperContext, params: FullParams,
                  samples: np.ndarray, n_processors: int) -> F.TranscribeResult:
    if n_processors <= 1:
        return F.whisper_full(ctx, params, samples)

    samples = np.asarray(samples, np.float32)

    # VAD filtering happens once, up front (whisper.cpp:7813-7824)
    if params.vad:
        from ..vad import segments as VS
        probs = ctx.get_vad(params.vad_model_path).detect_speech(samples)
        vsegs = VS.segments_from_probs(probs, params.vad_params)
        if not vsegs:
            return F.TranscribeResult(segments=[])
        fr = VS.filter_samples(samples, vsegs, params.vad_params)
        if fr.samples.size == 0:
            return F.TranscribeResult(segments=[])
        samples = fr.samples
    n_samples = len(samples)
    offset_samples = SAMPLE_RATE * params.offset_ms // 1000
    per_proc = (n_samples - offset_samples) // n_processors

    bounds = []
    for i in range(n_processors):
        if i == 0:
            bounds.append((0, offset_samples + per_proc))
        else:
            start = offset_samples + i * per_proc
            end = n_samples if i == n_processors - 1 else start + per_proc
            bounds.append((start, end))
    chunks = [samples[lo:hi] for lo, hi in bounds]

    p0 = dataclasses.replace(params, vad=False)
    p_rest = dataclasses.replace(params, vad=False, offset_ms=0, print_progress=False,
                                 new_segment_callback=None, progress_callback=None)

    # eligibility is judged with vad cleared (it was applied above) and on
    # offset_ms as given: seeking changes chunk 0's mel normalization
    # window, which only the threaded route reproduces
    if _batch_route_eligible(ctx, p0):
        seg_lists, timings = transcribe_chunks_with_timings(ctx, p_rest, chunks)
        chunk_results = [F.TranscribeResult(segments=segs, timings=timings[i])
                         for i, segs in enumerate(seg_lists)]
    else:
        # one thread per chunk, shared read-only weights, independent states
        # (whisper.cpp:7856-7861)
        with ThreadPoolExecutor(max_workers=n_processors) as pool:
            futures = [pool.submit(F.whisper_full, ctx, p0 if i == 0 else p_rest, chunks[i])
                       for i in range(n_processors)]
            chunk_results = [f.result() for f in futures]

    result = chunk_results[0]
    offset_t = params.offset_ms // 10
    for i in range(1, n_processors):
        shift = 100 * (bounds[i][0] - offset_samples) // SAMPLE_RATE + offset_t
        for seg in chunk_results[i].segments:
            seg.t0 += shift
            seg.t1 += shift
            if result.segments:
                seg.t0 = max(seg.t0, result.segments[-1].t1)
            result.segments.append(seg)
            if params.new_segment_callback:
                params.new_segment_callback(result, 1)
        t = chunk_results[i].timings
        result.timings.t_mel_ms += t.t_mel_ms
        result.timings.t_encode_ms += t.t_encode_ms
        result.timings.t_decode_ms += t.t_decode_ms
        result.timings.t_sample_ms += t.t_sample_ms
        result.timings.n_encode += t.n_encode
        result.timings.n_decode += t.n_decode
        result.timings.n_sample += t.n_sample

    result.timings.t_mel_ms /= n_processors
    result.timings.t_encode_ms /= n_processors
    result.timings.t_decode_ms /= n_processors
    result.timings.t_sample_ms /= n_processors
    return result
