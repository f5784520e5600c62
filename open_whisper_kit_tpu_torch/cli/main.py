"""whisper-cli-compatible transcription CLI of the PyTorch port (port of
open_whisper_kit_tpu/cli/main.py).

Flag surface mirrors the reference CLI (examples/cli/cli.cpp:132-229). As
in whisper.cpp, `-ng/--no-gpu` runs on the CPU and `-dev/--device N` picks
the card `cuda:N` (the default is card 0, and without CUDA the CLI raises);
the CoreML/OpenVINO flags are accepted for compatibility and do nothing.
The JAX package's compile-cache set-up has no counterpart here (the
kernels are built once by ops/_build.py).

Usage:  python -m open_whisper_kit_tpu_torch.cli.main -m model.bin -f audio.wav -otxt
        (add -ng to run on the CPU)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="whisper-cli", add_help=True)
    p.add_argument("-t", "--threads", type=int, default=4)
    p.add_argument("-p", "--processors", type=int, default=1)
    p.add_argument("-ot", "--offset-t", type=int, default=0, dest="offset_t_ms")
    p.add_argument("-on", "--offset-n", type=int, default=0, dest="offset_n")
    p.add_argument("-d", "--duration", type=int, default=0, dest="duration_ms")
    p.add_argument("-mc", "--max-context", type=int, default=-1)
    p.add_argument("-ml", "--max-len", type=int, default=0)
    p.add_argument("-bo", "--best-of", type=int, default=5)
    p.add_argument("-bs", "--beam-size", type=int, default=-1)
    p.add_argument("-ac", "--audio-ctx", type=int, default=0)
    p.add_argument("-wt", "--word-thold", type=float, default=0.01)
    p.add_argument("-et", "--entropy-thold", type=float, default=2.40)
    p.add_argument("-lpt", "--logprob-thold", type=float, default=-1.0)
    p.add_argument("-nth", "--no-speech-thold", type=float, default=0.6)
    p.add_argument("-tp", "--temperature", type=float, default=0.0)
    p.add_argument("-tpi", "--temperature-inc", type=float, default=0.2)
    p.add_argument("-debug", "--debug-mode", action="store_true")
    p.add_argument("-tr", "--translate", action="store_true")
    p.add_argument("-di", "--diarize", action="store_true")
    p.add_argument("-tdrz", "--tinydiarize", action="store_true")
    p.add_argument("-sow", "--split-on-word", action="store_true")
    p.add_argument("-nf", "--no-fallback", action="store_true")
    p.add_argument("-otxt", "--output-txt", action="store_true")
    p.add_argument("-ovtt", "--output-vtt", action="store_true")
    p.add_argument("-osrt", "--output-srt", action="store_true")
    p.add_argument("-owts", "--output-words", action="store_true")
    p.add_argument("-olrc", "--output-lrc", action="store_true")
    p.add_argument("-fp", "--font-path", default="/System/Library/Fonts/Supplemental/Courier New Bold.ttf")
    p.add_argument("-ocsv", "--output-csv", action="store_true")
    p.add_argument("-oj", "--output-json", action="store_true")
    p.add_argument("-ojf", "--output-json-full", action="store_true")
    p.add_argument("-of", "--output-file", default="")
    p.add_argument("-np", "--no-prints", action="store_true")
    p.add_argument("-ps", "--print-special", action="store_true")
    p.add_argument("-pc", "--print-colors", action="store_true")
    p.add_argument("--print-confidence", action="store_true")
    p.add_argument("-pp", "--print-progress", action="store_true")
    p.add_argument("-nt", "--no-timestamps", action="store_true")
    p.add_argument("-l", "--language", default="en")
    p.add_argument("-dl", "--detect-language", action="store_true")
    p.add_argument("--prompt", default=None)
    p.add_argument("--carry-initial-prompt", action="store_true")
    p.add_argument("-m", "--model", default="models/ggml-base.en.bin")
    p.add_argument("-f", "--file", dest="files", action="append", default=[])
    p.add_argument("-oved", "--ov-e-device", default="CPU")   # compat no-op
    p.add_argument("-dtw", "--dtw", default="")
    p.add_argument("-ls", "--log-score", action="store_true")
    p.add_argument("-ng", "--no-gpu", action="store_true",
                   help="run on the CPU")
    p.add_argument("-dev", "--device", type=int, default=0,
                   help="the card to run on (cuda:N)")
    p.add_argument("-fa", "--flash-attn", action="store_true")
    p.add_argument("-nfa", "--no-flash-attn", action="store_true")
    p.add_argument("-sns", "--suppress-nst", action="store_true")
    p.add_argument("--suppress-regex", default=None)
    p.add_argument("--grammar", default=None)
    p.add_argument("--grammar-rule", default="")
    p.add_argument("--grammar-penalty", type=float, default=100.0)
    p.add_argument("--vad", action="store_true")
    p.add_argument("-vm", "--vad-model", default="")
    p.add_argument("-vt", "--vad-threshold", type=float, default=0.5)
    p.add_argument("-vspd", "--vad-min-speech-duration-ms", type=int, default=250)
    p.add_argument("-vsd", "--vad-min-silence-duration-ms", type=int, default=100)
    p.add_argument("-vmsd", "--vad-max-speech-duration-s", type=float,
                   default=float("inf"))
    p.add_argument("-vp", "--vad-speech-pad-ms", type=int, default=30)
    p.add_argument("-vo", "--vad-samples-overlap", type=float, default=0.1)
    # ours-only: bit-faithful reference RNG sampling for beam candidates
    # and t>0 fallbacks (see FullParams.ref_sampling)
    p.add_argument("--ref-sampling", action="store_true")
    # ours-only: compute dtype (bf16 is the serving default; f32 tracks
    # the reference's f32 accumulation closely enough for draw-level
    # parity under --ref-sampling)
    p.add_argument("--dtype", choices=["bf16", "f16", "f32"], default="bf16")
    # ours-only: speculative greedy decoding — a smaller same-vocab draft
    # model proposes tokens, the main model verifies them in one pass
    p.add_argument("--draft-model", default=None)
    p.add_argument("--spec-tokens", type=int, default=4)
    p.add_argument("files_pos", nargs="*", default=[])
    return p


def params_from_args(args) -> "FullParams":
    from ..decode.params import (BeamSearchParams, FullParams, GreedyParams,
                                 SamplingStrategy, VadParams)
    p = FullParams(
        strategy=(SamplingStrategy.BEAM_SEARCH if args.beam_size > 1
                  else SamplingStrategy.GREEDY),
        n_threads=args.threads,
        offset_ms=args.offset_t_ms,
        duration_ms=args.duration_ms,
        translate=args.translate,
        no_timestamps=args.no_timestamps,
        print_special=args.print_special,
        print_progress=args.print_progress,
        token_timestamps=args.output_words or args.output_json_full
        or args.max_len > 0,
        thold_pt=args.word_thold,
        # -owts defaults the wrap length to 60 chars (cli.cpp:1187)
        max_len=60 if args.output_words and args.max_len == 0 else args.max_len,
        split_on_word=args.split_on_word,
        audio_ctx=args.audio_ctx,
        tdrz_enable=args.tinydiarize,
        suppress_regex=args.suppress_regex,
        initial_prompt=args.prompt,
        carry_initial_prompt=args.carry_initial_prompt,
        language=args.language,
        detect_language=args.detect_language,
        suppress_nst=args.suppress_nst,
        temperature=args.temperature,
        temperature_inc=0.0 if args.no_fallback else args.temperature_inc,
        entropy_thold=args.entropy_thold,
        logprob_thold=args.logprob_thold,
        no_speech_thold=args.no_speech_thold,
        vad=args.vad,
        vad_model_path=args.vad_model or None,
        dtw_token_timestamps=bool(args.dtw),
        ref_sampling=args.ref_sampling,
    )
    if args.max_context >= 0:
        p.n_max_text_ctx = args.max_context
    p.greedy = GreedyParams(best_of=args.best_of)
    p.beam_search = BeamSearchParams(beam_size=args.beam_size)
    p.vad_params = VadParams(
        threshold=args.vad_threshold,
        min_speech_duration_ms=args.vad_min_speech_duration_ms,
        min_silence_duration_ms=args.vad_min_silence_duration_ms,
        max_speech_duration_s=args.vad_max_speech_duration_s,
        speech_pad_ms=args.vad_speech_pad_ms,
        samples_overlap=args.vad_samples_overlap,
    )
    return p


def device_from_args(args) -> str:
    """The torch device of -ng / -dev (whisper.cpp's use_gpu, gpu_device)."""
    return "cpu" if args.no_gpu else f"cuda:{args.device}"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    files = list(args.files) + list(args.files_pos)
    if not files:
        print("error: no input files specified", file=sys.stderr)
        return 1

    import torch

    from .. import api
    from ..audio.wav import load_wav
    from . import outputs as O

    params = params_from_args(args)
    dtype = {"bf16": torch.bfloat16, "f16": torch.float16,
             "f32": torch.float32}[args.dtype]
    tr = api.Transcriber(model_path=args.model, dtype=dtype,
                         draft_model_path=args.draft_model,
                         device=device_from_args(args))
    if args.draft_model:
        params.speculative = args.spec_tokens

    for fname in files:
        stereo = None
        if args.diarize:
            stereo_data = load_wav(fname, stereo=True)
            if stereo_data.ndim == 2 and stereo_data.shape[1] == 2:
                stereo = stereo_data
                audio = stereo_data.mean(axis=1)
            else:
                audio = stereo_data if stereo_data.ndim == 1 else stereo_data[:, 0]
        else:
            audio = load_wav(fname)

        if args.processors > 1:
            res = tr.full_parallel(params, audio, args.processors)
        else:
            res = tr.full(params, audio)

        if not args.no_prints:
            # segment print loop, reference cli.cpp:361-447 (whisper_print_segment_callback body)
            for s in res.segments:
                line = ""
                if not args.no_timestamps:
                    line += f"[{O.to_timestamp(s.t0)} --> {O.to_timestamp(s.t1)}]  "
                speaker = O._speaker(s, stereo) if args.diarize else ""
                if args.print_colors:
                    line += O.render_segment_tokens(
                        s, tr.ctx.vocab, mode="colors",
                        print_special=args.print_special, speaker=speaker)
                elif args.print_confidence:
                    line += O.render_segment_tokens(
                        s, tr.ctx.vocab, mode="confidence",
                        print_special=args.print_special, speaker=speaker)
                else:
                    line += speaker + (s.text.strip()
                                       if not args.no_timestamps else s.text)
                if args.tinydiarize and s.speaker_turn_next:
                    line += " [SPEAKER_TURN]"
                if args.no_timestamps and not args.diarize:
                    print(line, end="", flush=True)
                else:
                    print(line)
            if args.no_timestamps and not args.diarize:
                print()

        base = args.output_file or fname
        vocab = tr.ctx.vocab

        def out(ext, writer, **kw):
            with open(f"{base}.{ext}", "w") as f:
                writer(res, f, **kw)

        if args.output_txt:
            out("txt", O.write_txt, stereo=stereo)
        if args.output_vtt:
            out("vtt", O.write_vtt, stereo=stereo)
        if args.output_srt:
            out("srt", O.write_srt, stereo=stereo, offset_n=args.offset_n)
        if args.output_csv:
            out("csv", O.write_csv, stereo=stereo)
        if args.output_lrc:
            out("lrc", O.write_lrc, stereo=stereo)
        if args.output_json or args.output_json_full:
            out("json", O.write_json, full=args.output_json_full,
                model_type=tr.model_type, language=args.language, vocab=vocab,
                params=params, stereo=stereo)
        if args.log_score:
            out("score.txt", O.write_score, vocab=vocab)
        if args.output_words:
            # t_sec = float(n_samples + 1000) / SR (cli.cpp:1293)
            dur_s = np.float32(len(audio) + 1000) / 16000
            out("wts", O.write_wts, audio_path=fname, duration_s=float(dur_s),
                font=args.font_path, vocab=vocab, stereo=stereo)

    return 0


if __name__ == "__main__":
    sys.exit(main())
