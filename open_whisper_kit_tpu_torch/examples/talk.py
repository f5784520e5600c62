"""talk-llama analog: voice chat with an LLM (PyTorch port of
examples/talk.py).

Reimplements the reference's examples/talk-llama/talk-llama.cpp on this
stack: whisper (speech -> text) + the port's LLaMA runtime
(models/llama) for the reply + an external TTS command for speech
output. Same loop semantics as the reference:

* audio from live mic (--device, ALSA), WAV replay (--input-wav, for
  offline/testing) or raw s16le stdin;
* `vad_simple` energy gate on the last 1.25 s of a 2 s probe window,
  then transcription of the last --voice-ms of audio;
* optional wake command (Levenshtein similarity >= 0.7 on the leading
  words, talk-llama.cpp:608-616);
* transcript cleanup (bracketed text stripped, charset filter, first
  line only);
* the reply is generated against the k_prompt_llama dialog transcript
  with the antiprompt "{person}:" and spoken via `--speak` (a command
  receiving (voice_id, text-file), like the reference's speak script);
* --session saves/restores the LLM state (tokens + KV cache snapshot)
  so the initial prompt is not re-evaluated across runs
  (llama_state_load_file analog, talk-llama.cpp:452-476); the snapshot
  keeps the example script's .npz layout (KV cache in f32, n_past), so a
  session saved by either package resumes in the other.

Runs on the card unless `-ng` asks for the CPU (`-dev N`: cuda:N).
Example (offline replay):
    python -m open_whisper_kit_tpu_torch.examples.talk -mw ggml-base.en.bin \
        -ml llama.gguf --input-wav question.wav --speak "cat"
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import add_device_args, device_of

K_PROMPT_WHISPER = "A conversation with a person called {1}."

K_PROMPT_LLAMA = """Text transcript of a never ending dialog, where {0} interacts with an AI assistant named {1}.
{1} is helpful, kind, honest, friendly, good at writing and never fails to answer {0}'s requests immediately and with details and precision.
There are no annotations like (30 seconds passed...) or (to himself), just what {0} and {1} say aloud to each other.
The transcript only includes text, it does not include markup like HTML and Markdown.
{1} responds with short and concise answers.

{0}{4} Hello, {1}!
{1}{4} Hello {0}! How may I help you today?
{0}{4} What time is it?
{1}{4} It is {2} o'clock.
{0}{4} What year is it?
{1}{4} We are in {3}.
{0}{4} What is a cat?
{1}{4} A cat is a domestic species of small carnivorous mammal. It is the only domesticated species in the family Felidae.
{0}{4} Name a color.
{1}{4} Blue
{0}{4}"""


def similarity(s0: str, s1: str) -> float:
    """Levenshtein similarity (reference common.cpp:648-670)."""
    if not s0 and not s1:
        return 1.0
    prev = list(range(len(s1) + 1))
    for i in range(1, len(s0) + 1):
        col = [i] + [0] * len(s1)
        for j in range(1, len(s1) + 1):
            col[j] = min(1 + col[j - 1], 1 + prev[j],
                         prev[j - 1] + (0 if s0[i - 1] == s1[j - 1] else 1))
        prev = col
    return 1.0 - prev[-1] / max(len(s0), len(s1))


def clean_heard(text: str) -> str:
    """talk-llama.cpp:624-646 transcript cleanup."""
    text = re.sub(r"\[.*?\]", "", text)
    text = re.sub(r"\(.*?\)", "", text)
    text = re.sub(r"[^a-zA-Z0-9åäöÅÄÖ"
                  r"\.,\?!\s\:\'\-]", "", text)
    text = text.split("\n", 1)[0]
    return text.strip()


def speak_with_file(speak_cmd: str, text: str, speak_file: str,
                    voice_id: int = 2) -> None:
    if not speak_cmd:
        return
    try:
        Path(speak_file).write_text(text)
        subprocess.run([speak_cmd, str(voice_id), speak_file],
                       timeout=60, check=False)
    except Exception as ex:  # TTS failure must not kill the chat loop
        print(f"[speak failed: {ex}]", file=sys.stderr)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("-mw", "--model-whisper", required=True)
    p.add_argument("-ml", "--model-llama", required=True)
    p.add_argument("-p", "--person", default="Georgi")
    p.add_argument("-bn", "--bot-name", default="LLaMA")
    p.add_argument("-w", "--wake-command", default="")
    p.add_argument("-ho", "--heard-ok", default="")
    p.add_argument("-l", "--language", default="en")
    p.add_argument("-mt", "--max-tokens", type=int, default=32,
                   help="max whisper tokens per audio chunk")
    p.add_argument("--reply-tokens", type=int, default=64,
                   help="max LLM tokens per reply")
    p.add_argument("-vms", "--voice-ms", type=int, default=10000)
    p.add_argument("-ac", "--audio-ctx", type=int, default=0)
    p.add_argument("-vth", "--vad-thold", type=float, default=0.6)
    p.add_argument("-fth", "--freq-thold", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--top-p", type=float, default=0.80)
    p.add_argument("--min-p", type=float, default=0.01)
    p.add_argument("--temp", type=float, default=0.30)
    p.add_argument("--min-keep", type=int, default=1)
    p.add_argument("-tr", "--translate", action="store_true")
    p.add_argument("-vp", "--verbose-prompt", action="store_true")
    p.add_argument("-s", "--speak", default="", help="TTS command")
    p.add_argument("-sf", "--speak-file", default="owk_to_speak.txt")
    p.add_argument("--prompt-file", default="")
    p.add_argument("--session", default="",
                   help="LLM state cache file (may be large)")
    p.add_argument("-f", "--file", default="", help="text output file")
    p.add_argument("--input-wav", default="",
                   help="offline replay instead of the mic")
    p.add_argument("--device", default="",
                   help="ALSA capture device (e.g. 'default')")
    p.add_argument("--max-turns", type=int, default=0,
                   help="stop after N replies (0 = run forever)")
    add_device_args(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..decode.full import WhisperContext
    from ..models.llama.model import LlamaContext

    device = device_of(args)
    ctx_w = WhisperContext.from_file(args.model_whisper, dtype=torch.bfloat16,
                                     device=device)
    lctx = LlamaContext(gguf_path=args.model_llama, device=device)
    return chat(args, ctx_w, lctx)


def chat(args, ctx_w, lctx) -> int:
    """The voice-chat loop of `main` on a loaded whisper context and
    LlamaContext (both on one device); `args` from build_parser()."""
    import torch

    from ..decode.full import whisper_full
    from ..decode.params import FullParams
    from ..decode.stream import vad_simple
    from ..models.llama.model import SampleParams
    from ..utils import state as ST

    chat_symb = ":"
    prompt_whisper = K_PROMPT_WHISPER.replace("{1}", args.bot_name)
    base = (Path(args.prompt_file).read_text() if args.prompt_file
            else K_PROMPT_LLAMA)
    prompt_llama = " " + base
    prompt_llama = (prompt_llama.replace("{0}", args.person)
                    .replace("{1}", args.bot_name)
                    .replace("{2}", time.strftime("%H:%M"))
                    .replace("{3}", time.strftime("%Y"))
                    .replace("{4}", chat_symb))

    sp = SampleParams(temp=args.temp, top_k=args.top_k, top_p=args.top_p,
                      min_p=args.min_p, min_keep=args.min_keep)
    embd_inp = lctx.vocab.encode(prompt_llama, add_special=True)

    # session restore: exact-prompt match resumes the snapshot
    session = Path(args.session) if args.session else None
    restored = False
    if session and session.exists():
        try:
            snap = ST.load_state(session)
            if list(snap["tokens"]) == embd_inp:
                lctx.kv_k = torch.from_numpy(np.asarray(snap["kv_k"])).to(
                    lctx.device, lctx.kv_k.dtype)
                lctx.kv_v = torch.from_numpy(np.asarray(snap["kv_v"])).to(
                    lctx.device, lctx.kv_v.dtype)
                lctx.n_past = int(snap["n_past"])
                restored = True
                print(f"[session restored: {len(embd_inp)} prompt tokens]",
                      file=sys.stderr)
        except Exception as ex:
            print(f"[session load failed: {ex}]", file=sys.stderr)

    if not restored:
        lctx.eval_tokens(embd_inp)
        if session:
            ST.save_state(
                session,
                tokens=np.asarray(embd_inp, np.int32),
                kv_k=lctx.kv_k.float(),
                kv_v=lctx.kv_v.float(),
                n_past=np.asarray(lctx.n_past))

    if args.verbose_prompt:
        print(prompt_llama)

    n_keep = lctx.n_past
    antiprompt = args.person + chat_symb
    fout = open(args.file, "a") if args.file else None

    # -- audio source ------------------------------------------------------
    capture = None
    replay = None
    if args.input_wav:
        from ..audio.wav import load_wav
        replay = load_wav(args.input_wav)
    elif args.device:
        from ..audio.native import LiveCapture
        capture = LiveCapture(device=args.device, rate=16000,
                              buffer_ms=30_000)
    else:
        print("no --input-wav/--device; reading s16le pcm from stdin",
              file=sys.stderr)

    wake_words = args.wake_command.split()
    print(f"{args.person}{chat_symb}", end="", flush=True)

    def transcribe(pcm: np.ndarray) -> str:
        fp = FullParams(
            print_progress=False, no_context=True, single_segment=True,
            max_tokens=args.max_tokens, language=args.language,
            translate=args.translate, no_timestamps=True,
            initial_prompt=prompt_whisper,
            audio_ctx=args.audio_ctx)
        res = whisper_full(ctx_w, fp, pcm)
        return "".join(s.text for s in res.segments).strip()

    n_turns = 0
    while True:
        # -- obtain one utterance -----------------------------------------
        if replay is not None:
            if replay is True:
                break                       # one-shot in replay mode
            pcm, replay = replay, True
        elif capture is not None:
            time.sleep(0.1)
            probe = capture.get(2000)
            if len(probe) < 16000 or not vad_simple(
                    probe, 1250, args.vad_thold, args.freq_thold):
                continue
            pcm = capture.get(args.voice_ms)
        else:
            raw = sys.stdin.buffer.read(2 * 16000 * args.voice_ms // 1000)
            if not raw:
                break
            pcm = (np.frombuffer(raw, np.int16).astype(np.float32)
                   / 32768.0)

        all_heard = clean_heard(transcribe(pcm))
        words = all_heard.split()

        if wake_words:
            heard_wake = " ".join(words[:len(wake_words)])
            text_heard = " ".join(words[len(wake_words):])
            if similarity(heard_wake, args.wake_command) < 0.7 \
                    or not text_heard:
                if capture:
                    capture.get(0)          # drain
                continue
        else:
            text_heard = " ".join(words)

        if not text_heard:
            continue

        if args.heard_ok:
            speak_with_file(args.speak, args.heard_ok, args.speak_file)

        text_heard = " " + text_heard + "\n" + args.bot_name + chat_symb
        print(text_heard, end="", flush=True)
        if fout:
            fout.write(text_heard)

        # -- context rollover (talk-llama.cpp:672-684) --------------------
        toks = lctx.vocab.encode(text_heard, add_special=False)
        if lctx.n_past + len(toks) + args.reply_tokens >= lctx.n_ctx:
            lctx.reset()
            lctx.eval_tokens(embd_inp)      # re-ingest the base dialog
            # (the reference re-feeds the last n_prev tokens; the base
            # prompt alone keeps the persona without unbounded growth)
        room = lctx.n_ctx - lctx.n_past - args.reply_tokens - 1
        if len(toks) > room:                # overlong utterance: keep the
            toks = toks[-max(room, 2):]     # tail (ends in "\n{bot}:")

        reply = lctx.generate(
            toks, sp, max_tokens=args.reply_tokens,
            antiprompts=[antiprompt], seed=args.seed + n_turns,
            on_piece=lambda s: print(s, end="", flush=True))
        print()
        if fout:
            fout.write(reply + "\n")
        speak_with_file(args.speak, reply.strip(), args.speak_file)

        n_turns += 1
        if args.max_turns and n_turns >= args.max_turns:
            break
        if capture:
            capture.get(0)                  # drain processed audio
        print(f"{args.person}{chat_symb}", end="", flush=True)

    if fout:
        fout.close()
    if capture:
        capture.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
