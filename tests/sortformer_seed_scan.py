"""Seed scan for the diarization parity tests (not collected by pytest).

Runs the JAX package's diarizer (CPU, the TINY config) on every input
tests/test_torch_sortformer.py and tests/test_torch_diarize.py compare, and
on the same input scaled by 1 +- 2^-20, 2^-16 and 2^-13. A case holds when
its RTTM segments stay the same under every scaling; the line gives the
largest probability move per scaling. A discrete decision (a top-K pick in
the speaker cache, a 0.5 crossing) that float noise could flip shows as a
segment change or a jump far above the others.

    JAX_PLATFORMS=cpu python tests/sortformer_seed_scan.py
"""

import dataclasses
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from open_whisper_kit_tpu.align import rttm as R  # noqa: E402
from open_whisper_kit_tpu.io.gguf import load_gguf  # noqa: E402
from open_whisper_kit_tpu.models.sortformer import export as E  # noqa: E402
from open_whisper_kit_tpu.models.sortformer import model as M  # noqa: E402
from open_whisper_kit_tpu.models.sortformer import streaming as S  # noqa: E402

TINY = M.SortformerConfig(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                          ff_expansion=2, subsampling_channels=8,
                          tf_layers=2, tf_d_model=16, tf_heads=4, tf_ff=32)
SMALL = {
    "small_fifo": S.StreamConfig(chunk_len=8, fifo_len=16, spkcache_len=16,
                                 spkcache_update_period=12, chunk_left_context=1,
                                 chunk_right_context=1, spkcache_sil_frames_per_spk=1),
    "small_rc3": S.StreamConfig(chunk_len=6, fifo_len=24, spkcache_len=20,
                                spkcache_update_period=16, chunk_right_context=3),
    "small_nofifo": S.StreamConfig(chunk_len=10),
}


def audio(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def wav_audio(seconds, seed):
    """audio() through the tests' 16-bit WAV file and load_wav."""
    return (np.clip(audio(seconds, seed), -1, 1) * 32767).astype("<i2").astype(np.float32) / 32768.0


def stream(d, cfg, x, piece):
    s = S.SortformerStream(d, cfg)
    for i in range(0, len(x), piece):
        s.feed(x[i:i + piece])
    s.finish()
    return s.probs()


def main():
    params = M.init_params(TINY, seed=0)
    d32 = S.SortformerDiarizer(TINY, params)
    path = Path(tempfile.mkdtemp()) / "tiny-f16.gguf"
    E.write_sortformer_gguf(path, TINY, params, half=True)
    d16 = S.SortformerDiarizer(*M.params_from_gguf(load_gguf(path)))
    P = S.PRESETS
    cases = {}
    for name, cfg, secs in (("offline", P["offline"], 30), ("low_latency", P["low_latency"], 30),
                            *((k, v, 7) for k, v in SMALL.items())):
        for seed in (0, 2):   # the host-loop and the device-loop tests
            cases[f"{name} {secs} s, seed {seed}"] = (
                lambda k, cfg=cfg, secs=secs, seed=seed: [d32.diarize(audio(secs, seed) * k, cfg)], 11)
    cases["batch small_fifo 5/3/5 s, seeds 20-22"] = (lambda k: d32.diarize_batch(
        [audio(5, 20) * k, audio(3, 21) * k, audio(5, 22) * k], SMALL["small_fifo"]), 11)
    rc2 = dataclasses.replace(SMALL["small_fifo"], chunk_right_context=2)
    cases["stream small_fifo rc 2, 6 s, seed 9"] = (
        lambda k: [stream(d32, rc2, audio(6, 9) * k, 5000)], 11)
    cases["stream low_latency 16 s, seed 9"] = (
        lambda k: [stream(d32, P["low_latency"], audio(16, 9) * k, 5000)], 11)
    for preset in ("offline", "low_latency", "2s"):
        cases[f"f16 file {preset} 16 s, seed 0"] = (
            lambda k, preset=preset: [d16.diarize(audio(16, 0) * k, P[preset])], 11)
    cases["f32 batch 3s 12/9 s, seeds 1-2"] = (lambda k: d32.diarize_batch(
        [audio(12, 1) * k, audio(9, 2) * k], P["3s"]), 11)
    cases["f16 stream low_latency 16 s, seed 3"] = (
        lambda k: [stream(d16, P["low_latency"], audio(16, 3) * k, 8000)], 11)
    cases["f16 align low_latency 25 s, seed 2, median 3"] = (
        lambda k: [d16.diarize(audio(25, 2) * k, P["low_latency"])], 3)
    for preset in ("offline", "low_latency"):
        cases[f"f16 CLI wav {preset} 20 s, seed 1"] = (
            lambda k, preset=preset: [d16.diarize(wav_audio(20, 1) * k, P[preset])], 11)

    def segs(p, mw):
        return [(s.start, s.duration, s.speaker) for s in R.probs_to_segments(p, 0.5, mw, "x")]

    n_bad = 0
    for name, (run, mw) in cases.items():
        base = run(np.float32(1))
        moves, ok = [], True
        for e in (20, 16, 13):
            for sg in (1, -1):
                got = run(np.float32(1 + sg * 2.0 ** -e))
                dmax = max(float(np.abs(a - b).max()) for a, b in zip(got, base))
                same = all(segs(a, mw) == segs(b, mw) for a, b in zip(got, base))
                ok &= same
                moves.append(f"{'+' if sg > 0 else '-'}2^-{e} {dmax:.1e}{'' if same else ' (segments differ)'}")
        n_bad += not ok
        print(f"{name}: {'holds' if ok else 'FRAGILE'}; {', '.join(moves)}", flush=True)
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
