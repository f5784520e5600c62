"""whisper language-server: JSON-RPC 2.0 over stdio with LSP framing
(PyTorch port of open_whisper_kit_tpu/cli/lsp.py).

Port of examples/lsp/lsp.cpp (reference): methods `unguided` (free
transcription), `guided` (pick the most likely command from a registered
set by first-token probability, lsp.cpp:205-289), `registerCommandset`
(lsp.cpp:291-330) and `seek` (unsupported, parity error -32601), framed as
`Content-Length: N\\r\\n\\r\\n<json>` messages (lsp.cpp:391-412).

Divergences by design:

1. The reference records from an SDL microphone and gates on VAD
   (wait_for_vad); a serving process has no mic, so requests carry
   their audio instead — `audio_path` (wav) or `audio_b64` (base64
   float32 PCM @16 kHz) in params.
2. registerCommandset joins the guided-prompt words with ", " and strips
   the trailing ", " before appending ". Selected word:". The reference
   (lsp.cpp:320-322) concatenates the words with NO separator and then
   chops the last two characters of the final word via substr — an
   apparent bug (the separator `k_prompt += s + ", "` was evidently
   intended, matching the chop of exactly 2 chars). We implement the
   intent; guided-mode prompt tokens therefore differ from the
   reference's for multi-word commandsets. `--strict-prompt-parity`
   (LspServer(strict_prompt_parity=True)) reproduces the reference's
   literal bytes for A/B harnesses.

`main` runs on the card (cuda:0; without CUDA it raises) unless `-ng`
asks for the CPU; `-dev N` picks cuda:N:

    python -m open_whisper_kit_tpu_torch.cli.lsp -m model.bin
"""

from __future__ import annotations

import base64
import json
import sys

import numpy as np
import torch

PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
WHISPER_FAILED = -32803
DUPLICATE_TOKEN = -31000


class LspServer:
    """Stateful request handler (testable without stdio framing)."""

    def __init__(self, ctx, language: str = "en", translate: bool = False,
                 max_tokens: int = 32, audio_ctx: int = 0,
                 print_special: bool = False, strict_prompt_parity: bool = False):
        self.ctx = ctx
        self.language = language
        self.translate = translate
        self.max_tokens = max_tokens
        self.audio_ctx = audio_ctx
        self.print_special = print_special
        # reproduce the reference's literal guided-prompt construction
        # (separator-less concat + 2-char chop, lsp.cpp:320-322) for
        # byte-level A/B harnesses; default is the intended ", " join
        # (module docstring, divergence #2)
        self.strict_prompt_parity = strict_prompt_parity
        self.commandsets: list[dict] = []

    # -- audio ---------------------------------------------------------------

    def _load_audio(self, jparams: dict) -> tuple[np.ndarray, int]:
        if "audio_b64" in jparams:
            raw = base64.b64decode(jparams["audio_b64"])
            return np.frombuffer(raw, dtype=np.float32), int(
                jparams.get("timestamp", 0))
        if "audio_path" in jparams:
            from ..audio.wav import load_wav
            return load_wav(jparams["audio_path"]), int(
                jparams.get("timestamp", 0))
        raise _err(INVALID_REQUEST, "audio_path or audio_b64 required")

    # -- methods (lsp.cpp:356-366) -------------------------------------------

    def unguided(self, jparams: dict) -> dict:
        """lsp.cpp:159-202."""
        from ..decode.full import whisper_full
        from ..decode.params import FullParams

        samples, ts = self._load_audio(jparams)
        p = FullParams(
            print_progress=False, print_special=self.print_special,
            translate=self.translate,
            no_context=bool(jparams.get("no_context", True)),
            single_segment=True, max_tokens=self.max_tokens,
            language=self.language, audio_ctx=self.audio_ctx,
            suppress_nst=True)
        if "prompt" in jparams:
            p.prompt_tokens = self.ctx.vocab.tokenize(jparams["prompt"])
        res = whisper_full(self.ctx, p, samples)
        text = res.segments[0].text if res.segments else ""
        return {"transcription": text, "timestamp": ts}

    def guided(self, jparams: dict) -> dict:
        """lsp.cpp:205-289: decode the commandset prompt against the audio
        window and rank commands by their first token's probability."""
        if not self.commandsets:
            raise _err(INVALID_REQUEST, "no commandset registered")
        cs = self.commandsets[int(
            jparams.get("commandset_index", len(self.commandsets) - 1))]
        samples, ts = self._load_audio(jparams)

        from ..audio import mel as mel_mod
        from ..models.whisper import model as M

        ctx = self.ctx
        mel = mel_mod.log_mel_spectrogram(
            np.asarray(samples, np.float32), ctx.filters, device=ctx.device)
        _eo, xk, xv = ctx.encode_window(mel.data, 0, self.audio_ctx)

        vocab = ctx.vocab
        prompt = [vocab.token_prev] + cs["prompt_tokens"] + [vocab.token_sot]
        if vocab.is_multilingual:
            from ..decode import tokenizer as tok_mod
            prompt.append(vocab.token_lang(tok_mod.lang_id(self.language)))
            prompt.append(vocab.token_translate if self.translate
                          else vocab.token_transcribe)

        kv_k, kv_v = M.init_kv_cache(ctx.cfg, 1, dtype=ctx.dtype, device=ctx.device)
        toks = torch.tensor([prompt], dtype=torch.long, device=ctx.device)
        logits, _, _ = M.decode_impl(ctx.cfg, ctx.params["decoder"], toks,
                                     kv_k, kv_v, 0, xk, xv,
                                     logits_pos=len(prompt) - 1)
        row = ctx.reads.fetch(logits[0, 0].float())
        e = np.exp(row - row.max())
        probs = e / e.sum()

        first_tokens = [c["tokens"][0] for c in cs["commands"]]
        best = int(np.argmax(probs[first_tokens]))
        return {"command_index": best,
                "command_text": cs["commands"][best]["plaintext"],
                "timestamp": ts}

    def register_commandset(self, jparams) -> dict:
        """lsp.cpp:291-330."""
        vocab = self.ctx.vocab
        commands = []
        seen: set[int] = set()
        k_prompt = " select one from the available words: "
        for s in jparams:
            toks = vocab.tokenize(" " + s)
            if not toks:
                raise _err(INVALID_REQUEST, f"failed to tokenize: {s}")
            if toks[0] in seen:
                raise _err(DUPLICATE_TOKEN,
                           "Duplicate token in token set: " + s)
            seen.add(toks[0])
            commands.append({"tokens": [toks[0]], "plaintext": s})
            k_prompt += s if self.strict_prompt_parity else s + ", "
        k_prompt = k_prompt[:-2] + ". Selected word:"
        cs = {"commands": commands,
              "prompt_tokens": vocab.tokenize(k_prompt)}
        index = len(self.commandsets)
        self.commandsets.append(cs)
        return {"index": index}

    def seek(self, jparams) -> dict:
        raise _err(METHOD_NOT_FOUND, "Seeking is not yet supported.")

    # -- jsonrpc dispatch (lsp.cpp:343-380) ----------------------------------

    def handle(self, body: dict) -> dict:
        rid = body.get("id")
        try:
            if body.get("jsonrpc") != "2.0":
                raise _err(INVALID_REQUEST, "invalid jsonrpc version")
            method = body.get("method")
            jparams = body.get("params", {})
            if method == "unguided":
                res = self.unguided(jparams)
            elif method == "guided":
                res = self.guided(jparams)
            elif method == "registerCommandset":
                res = self.register_commandset(jparams)
            elif method == "seek":
                res = self.seek(jparams)
            else:
                raise _err(METHOD_NOT_FOUND, f"unknown method: {method}")
            return {"jsonrpc": "2.0", "result": res, "id": rid}
        except _JsonRpcError as ex:
            return {"jsonrpc": "2.0", "error": ex.error, "id": rid}
        except Exception as ex:  # one bad request must not kill the server
            return {"jsonrpc": "2.0",
                    "error": {"code": WHISPER_FAILED,
                              "message": f"{type(ex).__name__}: {ex}"},
                    "id": rid}


class _JsonRpcError(Exception):
    def __init__(self, error: dict):
        super().__init__(error.get("message", ""))
        self.error = error


def _err(code: int, message: str) -> _JsonRpcError:
    return _JsonRpcError({"code": code, "message": message})


def _read_message(stdin) -> dict | None:
    """LSP framing: Content-Length header + \\r\\n\\r\\n + body."""
    length = None
    while True:
        line = stdin.readline()
        if not line:
            return None
        line = line.strip()
        if not line:
            if length is not None:
                break
            continue
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":", 1)[1])
    body = stdin.read(length)
    return json.loads(body)


def _write_message(stdout, obj: dict) -> None:
    data = json.dumps(obj).encode("utf-8")
    stdout.write(b"Content-Length: %d\r\n\r\n" % len(data))
    stdout.write(data)
    stdout.flush()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser("owk-torch-whisper-lsp")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-l", "--language", default="en")
    ap.add_argument("-tr", "--translate", action="store_true")
    ap.add_argument("-mt", "--max-tokens", type=int, default=32)
    ap.add_argument("-ac", "--audio-ctx", type=int, default=0)
    ap.add_argument("-ps", "--print-special", action="store_true")
    ap.add_argument("--strict-prompt-parity", action="store_true",
                    help="reproduce the reference's literal guided-prompt "
                         "concatenation (lsp.cpp:320-322) byte-for-byte")
    ap.add_argument("-ng", "--no-gpu", action="store_true", help="run on the CPU")
    ap.add_argument("-dev", "--device", type=int, default=0,
                    help="CUDA device index")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..decode.full import WhisperContext
    from .main import device_from_args
    ctx = WhisperContext.from_file(args.model, device=device_from_args(args))
    srv = LspServer(ctx, language=args.language, translate=args.translate,
                    max_tokens=args.max_tokens, audio_ctx=args.audio_ctx,
                    print_special=args.print_special,
                    strict_prompt_parity=args.strict_prompt_parity)

    stdin = sys.stdin.buffer
    stdout = sys.stdout.buffer
    while True:
        body = _read_message(stdin)
        if body is None:
            return 0
        _write_message(stdout, srv.handle(body))


if __name__ == "__main__":
    raise SystemExit(main())
