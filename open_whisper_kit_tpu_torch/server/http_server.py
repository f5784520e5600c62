"""HTTP transcription server of the PyTorch port (port of
open_whisper_kit_tpu/server/http_server.py).

Route/parameter-compatible port of the reference server
(examples/server/server.cpp:797-1165):

    POST /inference  — multipart form: file=<audio>, plus whisper params
                       (temperature, response_format text|json|verbose_json|
                       srt|vtt, language, translate, ...)
    POST /load       — {"model": path} hot-swap
    GET  /health     — {"status":"ok"}

plus the capability routes the non-Python clients bind (bindings/*):

    POST /detect-language — multipart file -> language + probability map
                            (whisper_lang_auto_detect, whisper.cpp:4021)
    POST /diarize         — multipart file -> RTTM text or JSON speaker
                            segments (requires --diarize-model; the
                            sortformer_diarize/to_rttm surface)
    POST /stream/start    — JSON params -> {"session": id}
    POST /stream/feed?session=ID   — raw s16le (or f32le) PCM body ->
                            {"events": [...]} incremental transcription
    POST /stream/finish?session=ID — flush + close -> final events
                            (the whisper-stream step/keep engine; the
                            reference addon.node StreamingSession analog)

Python stdlib http.server (threaded); no external web framework.

The models run on one torch device, the card unless `device` (`-ng` on the
command line) asks for the CPU; without CUDA the server raises at start-up
and never falls back to the CPU. Requests run on the handler threads and
the batcher's thread: every call that reaches the device holds
`ServerState.lock` (a /stream request takes its session's lock, then the
state lock), and the device is pinned to an indexed card at start-up, so
every thread uses the same card.

    python -m open_whisper_kit_tpu_torch.server.http_server -m model.bin [-ng]
"""

from __future__ import annotations

import dataclasses
import io
import json
import re
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..decode.full import _resolve_device


class ServerState:
    def __init__(self, model_path: str, dtype=None, mesh=None,
                 batch_window_ms: float = 0.0, max_batch: int = 8,
                 vad_model: str | None = None, request_path: str = "",
                 inference_path: str = "/inference",
                 public_path: str | None = None, convert: bool = False,
                 diarize_model: str | None = None,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "serving on a mesh is not ported to the PyTorch package yet")
        # the models load lazily: resolve the device now, so a missing card
        # fails at start-up, and pin its index for every handler thread
        self.device = _resolve_device(device)
        # RLock: load() holds it while the transcriber property re-enters
        self.lock = threading.RLock()
        self.model_path = model_path
        self._dtype = dtype
        self._transcriber = None
        self.vad_model = vad_model     # --vad-model (server.cpp -vm)
        self.request_path = request_path        # server.cpp --request-path
        self.inference_path = inference_path    # server.cpp --inference-path
        self.public_path = public_path          # server.cpp --public
        self.convert = convert                  # server.cpp --convert
        self.diarize_model = diarize_model      # sortformer GGUF for /diarize
        self._diarizer = None
        # streaming sessions (POST /stream/*): id -> _StreamSession
        self.sessions: dict[str, "_StreamSession"] = {}
        self._session_seq = 0
        self.batcher = (RequestBatcher(self, batch_window_ms, max_batch)
                        if batch_window_ms > 0 and max_batch > 1 else None)

    @property
    def diarizer(self):
        if self._diarizer is None:
            if not self.diarize_model:
                raise RuntimeError(
                    "server started without --diarize-model")
            with self.lock:
                if self._diarizer is None:
                    from ..api import Diarizer
                    self._diarizer = Diarizer(model_path=self.diarize_model,
                                              device=self.device)
        return self._diarizer

    def new_session(self, params) -> str:
        from ..decode.stream import StreamingTranscriber
        with self.lock:
            self._session_seq += 1
            sid = f"s{self._session_seq}"
            st = StreamingTranscriber(self.transcriber.ctx, params)
            self.sessions[sid] = _StreamSession(sid, st)
            # bound concurrent sessions; oldest-idle evicted first
            if len(self.sessions) > 32:
                oldest = min(self.sessions.values(), key=lambda s: s.last_used)
                self.sessions.pop(oldest.sid, None)
        return sid

    @property
    def transcriber(self):
        if self._transcriber is None:
            with self.lock:         # one lazy init even under concurrency
                if self._transcriber is None:
                    from ..api import Transcriber
                    self._transcriber = Transcriber(
                        model_path=self.model_path,
                        dtype=self._dtype or torch.bfloat16,
                        device=self.device)
        return self._transcriber

    def load(self, model_path: str):
        with self.lock:
            self.model_path = model_path
            self._transcriber = None
            _ = self.transcriber

    def run(self, p, audio):
        """One /inference request -> (TranscribeResult, transcriber).
        The transcriber that produced the result is returned so response
        formatting (vocab lookups, language detection) stays pinned to
        the SAME model even if POST /load hot-swaps it mid-flight."""
        if self.batcher is not None:
            return self.batcher.submit(p, audio)
        with self.lock:
            tr = self.transcriber
            return tr.full(p, audio), tr


class _StreamSession:
    """One /stream session: a StreamingTranscriber + a per-session lock
    (feeds for the SAME session serialize; different sessions still
    serialize on the device via the state lock)."""

    def __init__(self, sid: str, st):
        self.sid = sid
        self.st = st
        self.lock = threading.Lock()
        self.last_used = time.monotonic()


class _Req:
    def __init__(self, p, audio, key):
        self.p = p
        self.audio = audio
        self.key = key
        self.done = threading.Event()
        self.result = None
        self.transcriber = None
        self.error: Exception | None = None


class RequestBatcher:
    """Dynamic batching for concurrent /inference requests.

    The reference server serializes requests behind a mutex
    (examples/server/server.cpp whisper_mutex) — one request occupies the
    whole backend. The decode step is weight-stream-bound, so B concurrent
    requests cost nearly the same as one if their windows ride one
    lockstep dispatch. Requests arriving within `window_ms` of each
    other whose decode params are identical are grouped and run through
    decode/batch.py::transcribe_chunks_with_timings — each request keeps
    its OWN mel context and per-chunk host-fallback fidelity, so every
    response is identical to a serial whisper_full run (test-pinned).
    Ineligible requests (beam search, t>0 start, token timestamps, ...)
    fall back to the serial path under the state lock."""

    def __init__(self, state: ServerState, window_ms: float = 50.0,
                 max_batch: int = 8):
        self.state = state
        self.window_s = window_ms / 1e3
        self.max_batch = max_batch
        self.cv = threading.Condition()
        self.pending: list[_Req] = []
        self.n_dispatches = 0       # stats: lockstep groups run
        self.max_group = 0          # stats: largest group size seen
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="owk-batcher")
        self._thread.start()

    @staticmethod
    def _key(p):
        """Requests batch together only with IDENTICAL decode params
        (one FullParams drives the whole lockstep group) — every field
        the /inference handler can set that changes a lockstep-eligible
        decode must appear here; the handler's other fields turn the
        request away (parallel/dp._batch_route_eligible) or are read only
        under one that does (test-pinned)."""
        return (p.language, p.translate, p.temperature, p.temperature_inc,
                p.no_timestamps, p.audio_ctx, p.initial_prompt,
                p.greedy.best_of, p.suppress_nst, p.tdrz_enable,
                p.entropy_thold, p.logprob_thold, p.no_speech_thold,
                p.max_len, p.split_on_word, p.n_max_text_ctx,
                p.duration_ms, p.debug_mode)

    def submit(self, p, audio):
        from ..parallel.dp import _batch_route_eligible
        if not _batch_route_eligible(self.state.transcriber.ctx, p):
            with self.state.lock:
                tr = self.state.transcriber
                return tr.full(p, audio), tr
        req = _Req(p, audio, self._key(p))
        with self.cv:
            self.pending.append(req)
            self.cv.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result, req.transcriber

    def _run(self):
        while True:
            with self.cv:
                while not self.pending:
                    self.cv.wait()
                # batching window arms at the first pending arrival
                deadline = time.monotonic() + self.window_s
                while len(self.pending) < self.max_batch:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    self.cv.wait(timeout=rem)
                batch = self.pending[:self.max_batch]
                del self.pending[:len(batch)]
            groups: dict[tuple, list[_Req]] = {}
            for r in batch:
                groups.setdefault(r.key, []).append(r)
            for reqs in groups.values():
                self._run_group(reqs)

    def _run_group(self, reqs: list[_Req]):
        from ..decode.full import TranscribeResult
        self.n_dispatches += 1
        self.max_group = max(self.max_group, len(reqs))
        try:
            with self.state.lock:
                tr = self.state.transcriber
                if len(reqs) == 1:
                    results = [tr.full(reqs[0].p, reqs[0].audio)]
                else:
                    from ..decode.batch import transcribe_chunks_with_timings
                    segs, tims = transcribe_chunks_with_timings(
                        tr.ctx, reqs[0].p, [r.audio for r in reqs])
                    results = [TranscribeResult(segments=s, timings=t)
                               for s, t in zip(segs, tims)]
            for r, res in zip(reqs, results):
                r.result = res
                r.transcriber = tr
                r.done.set()
        except Exception as e:  # noqa: BLE001
            for r in reqs:
                r.error = e
                r.done.set()


def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        return {}
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(boundary):
        # drop the framing's one CRLF on each side, never the payload's own
        # trailing CR / LF bytes (a binary upload may end in them)
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        if not part or part.startswith(b"--"):
            continue
        if b"\r\n\r\n" not in part:
            continue
        head, _, value = part.partition(b"\r\n\r\n")
        nm = re.search(rb'name="([^"]+)"', head)
        if nm:
            fields[nm.group(1).decode()] = value
    return fields


def _load_audio_bytes(data: bytes, stereo: bool = False,
                      convert: bool = False):
    """Decode an uploaded payload; `convert` transcodes via ffmpeg first
    (server.cpp --convert / convert_to_wav, server.cpp:321-343)."""
    from ..audio.wav import load_wav
    if convert:
        import shutil
        import subprocess
        if shutil.which("ffmpeg") is None:
            raise RuntimeError(
                "--convert requires ffmpeg on the server (not found)")
        with tempfile.NamedTemporaryFile(suffix=".bin") as src, \
                tempfile.NamedTemporaryFile(suffix=".wav") as dst:
            src.write(data)
            src.flush()
            r = subprocess.run(
                ["ffmpeg", "-y", "-i", src.name, "-ar", "16000",
                 "-ac", "1", "-c:a", "pcm_s16le", dst.name],
                capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"ffmpeg conversion failed: {r.stderr[-300:]}")
            return load_wav(dst.name, stereo=stereo)
    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(data)
        f.flush()
        return load_wav(f.name, stereo=stereo)


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: str, ctype="application/json"):
            data = body.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            from urllib.parse import unquote, urlsplit
            rp = state.request_path
            path = urlsplit(self.path).path     # drop any query string
            if path == rp + "/health":
                self._send(200, json.dumps({"status": "ok"}))
            elif rp and path != rp and not path.startswith(rp + "/"):
                self._send(404, json.dumps({"error": "not found"}))
            elif state.public_path is not None:
                # static demo assets (server.cpp --public)
                import mimetypes
                import os.path
                rel = unquote(path[len(rp):]).lstrip("/") or "index.html"
                full = os.path.realpath(
                    os.path.join(state.public_path, rel))
                root = os.path.realpath(state.public_path)
                if not full.startswith(root + os.sep) and full != root:
                    self._send(404, json.dumps({"error": "not found"}))
                    return
                if os.path.isdir(full):
                    full = os.path.join(full, "index.html")
                if not os.path.isfile(full):
                    self._send(404, json.dumps({"error": "not found"}))
                    return
                ctype = (mimetypes.guess_type(full)[0]
                         or "application/octet-stream")
                with open(full, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._send(404, json.dumps({"error": "not found"}))

        def _detect_language(self, body):
            """POST /detect-language: multipart file -> detected language +
            probabilities (the whisper_lang_auto_detect surface,
            src/whisper.cpp:4021, for non-Python clients)."""
            fields = _parse_multipart(
                body, self.headers.get("Content-Type", ""))
            if "file" not in fields:
                self._send(400, json.dumps({"error": "no 'file' field"}))
                return
            audio = _load_audio_bytes(fields["file"], convert=state.convert)
            from ..audio import mel as mel_mod
            from ..compat import whisper_lang_str_full
            from ..decode import full as Fmod
            from ..decode import tokenizer as tok_mod
            with state.lock:
                tr = state.transcriber
                mel = mel_mod.log_mel_spectrogram(audio, tr.ctx.filters,
                                                  device=tr.ctx.device)
                lid, probs = Fmod.detect_language(tr.ctx, mel)
            self._send(200, json.dumps({
                "detected_language": whisper_lang_str_full(lid),
                "language": tok_mod.lang_str(lid),
                "probability": float(probs[lid]),
                "language_probabilities": {
                    tok_mod.LANGUAGES[i][0]: float(probs[i])
                    for i in range(len(probs)) if probs[i] > 0.001},
            }))

        def _diarize(self, body):
            """POST /diarize: multipart file -> RTTM text or JSON speaker
            segments (sortformer_diarize + sortformer_to_rttm surface,
            streaming-sortformer/src/sortformer.cpp:2271,2593)."""
            fields = _parse_multipart(
                body, self.headers.get("Content-Type", ""))
            if "file" not in fields:
                self._send(400, json.dumps({"error": "no 'file' field"}))
                return

            def fval(key, cast, default):
                if key in fields:
                    try:
                        return cast(fields[key].decode().strip())
                    except ValueError:
                        return default
                return default

            threshold = fval("threshold", float, 0.5)
            median_win = fval("median_window", int, 11)
            preset = fval("preset", str, "") or None
            response_format = fval("response_format", str, "json")
            file_id = fval("file_id", str, "audio")
            audio = _load_audio_bytes(fields["file"], convert=state.convert)
            dz = state.diarizer
            with state.lock:      # device access serializes
                _probs, segments = dz.diarize(
                    audio, stream_config=preset, threshold=threshold,
                    median_win=median_win, file_id=file_id)
            if response_format == "rttm":
                from ..align import rttm as _rttm
                self._send(200, _rttm.to_rttm(segments),
                           ctype="text/plain; charset=utf-8")
            else:
                self._send(200, json.dumps({"segments": [
                    {"speaker": s.speaker, "start": s.start,
                     "duration": s.duration} for s in segments]}))

        def _stream_route(self, path, body):
            """POST /stream/{start,feed,finish}: chunked streaming sessions
            (the whisper-stream step/keep engine behind HTTP; the reference
            addon.node's StreamingSession analog for every HTTP client)."""
            from urllib.parse import parse_qs, urlsplit
            q = parse_qs(urlsplit(self.path).query)
            if path.endswith("/start"):
                try:
                    req = json.loads(body or b"{}")
                except ValueError:
                    req = {}
                from ..decode.stream import StreamParams
                sp = StreamParams(
                    step_ms=int(req.get("step_ms", 3000)),
                    length_ms=int(req.get("length_ms", 10000)),
                    keep_ms=int(req.get("keep_ms", 200)),
                    max_tokens=int(req.get("max_tokens", 32)),
                    language=req.get("language", "en"),
                    translate=bool(req.get("translate", False)),
                    no_context=not bool(req.get("keep_context", False)),
                    vad_thold=float(req.get("vad_thold", 0.6)),
                    no_fallback=True)
                sid = state.new_session(sp)
                self._send(200, json.dumps({"session": sid}))
                return
            sid = (q.get("session") or [""])[0]
            sess = state.sessions.get(sid)
            if sess is None:
                self._send(404, json.dumps({"error": "unknown session"}))
                return
            import numpy as np
            fmt = (q.get("format") or ["s16le"])[0]
            if fmt == "f32le":
                pcm = np.frombuffer(body, dtype="<f4").astype(np.float32)
            else:
                pcm = np.frombuffer(body, dtype="<i2").astype(
                    np.float32) / 32768.0
            with sess.lock:
                sess.last_used = time.monotonic()
                with state.lock:
                    if path.endswith("/finish"):
                        events = (sess.st.feed(pcm) if len(pcm) else []
                                  ) + sess.st.flush()
                        state.sessions.pop(sid, None)
                    else:
                        events = sess.st.feed(pcm)
            self._send(200, json.dumps({"events": [
                {"text": e.text, "t0": e.t0, "t1": e.t1, "final": e.final,
                 "speaker_turn_next": e.speaker_turn_next}
                for e in events]}))

        def do_POST(self):
            from urllib.parse import urlsplit
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            rp = state.request_path
            path = urlsplit(self.path).path
            try:
                if path == rp + "/detect-language":
                    return self._detect_language(body)
                if path == rp + "/diarize":
                    return self._diarize(body)
                if path.startswith(rp + "/stream/"):
                    return self._stream_route(path, body)
            except Exception as e:  # noqa: BLE001
                self._send(500, json.dumps({"error": str(e)}))
                return
            if self.path == rp + "/load":
                try:
                    ctype = self.headers.get("Content-Type", "")
                    if ctype.startswith("application/x-www-form-urlencoded"):
                        from urllib.parse import parse_qs
                        req = {k: v[0] for k, v in
                               parse_qs(body.decode()).items()}
                    elif ctype.startswith("multipart/form-data"):
                        req = {k: v.decode() for k, v in
                               _parse_multipart(body, ctype).items()}
                    else:
                        req = json.loads(body or b"{}")
                    state.load(req["model"])
                    self._send(200, json.dumps({"status": "ok"}))
                except Exception as e:  # noqa: BLE001
                    self._send(500, json.dumps({"error": str(e)}))
                return
            if self.path != rp + state.inference_path:
                self._send(404, json.dumps({"error": "not found"}))
                return

            try:
                fields = _parse_multipart(
                    body, self.headers.get("Content-Type", ""))
                if "file" not in fields:
                    self._send(400, json.dumps(
                        {"error": "no 'file' field in multipart form data"}))
                    return

                import dataclasses

                from ..decode.params import FullParams, SamplingStrategy
                p = FullParams(print_progress=False)

                def fval(key, cast, default):
                    if key in fields:
                        try:
                            return cast(fields[key].decode().strip())
                        except ValueError:
                            return default
                    return default

                # parse_str_to_bool (server.cpp:476-482)
                fbool = lambda s: s in ("true", "1", "yes", "y")

                # full /inference parameter surface (server.cpp:483-615)
                p.language = fval("language", str, "en")
                if fval("detect_language", fbool, False):
                    p.language = "auto"
                    p.detect_language = True
                p.translate = fval("translate", fbool, False)
                p.temperature = fval("temperature", float, 0.0)
                p.temperature_inc = fval("temperature_inc", float, 0.2)
                p.no_timestamps = fval("no_timestamps", fbool, False)
                p.audio_ctx = fval("audio_ctx", int, 0)
                p.offset_ms = fval("offset_t", int, 0)
                offset_n = fval("offset_n", int, 0)
                p.duration_ms = fval("duration", int, 0)
                mc = fval("max_context", int, -1)
                if mc >= 0:
                    p.n_max_text_ctx = mc
                p.split_on_word = fval("split_on_word", fbool, False)
                p.entropy_thold = fval("entropy_thold", float, 2.4)
                p.logprob_thold = fval("logprob_thold", float, -1.0)
                p.debug_mode = fval("debug_mode", fbool, False)
                p.suppress_nst = (fval("suppress_non_speech", fbool, False)
                                  or fval("suppress_nst", fbool, False))
                p.tdrz_enable = fval("tinydiarize", fbool, False)
                diarize = fval("diarize", fbool, False)
                p.initial_prompt = (fields.get("prompt") or b"").decode() or None
                best_of = fval("best_of", int, 2)
                beam_size = fval("beam_size", int, -1)
                if beam_size > 1:
                    p.strategy = SamplingStrategy.BEAM_SEARCH
                    p.beam_search.beam_size = beam_size
                p.greedy.best_of = best_of
                response_format = fval("response_format", str, "json")
                # verbose_json always carries word timings (server.cpp:939)
                p.thold_pt = fval("word_thold", float, 0.01)
                p.token_timestamps = (not p.no_timestamps
                                      and response_format == "verbose_json")
                ml = fval("max_len", int, 0)
                p.max_len = 60 if ml == 0 else ml      # server.cpp:919
                p.vad = fval("vad", fbool, False)
                p.vad_model_path = state.vad_model
                p.vad_params = dataclasses.replace(
                    p.vad_params,
                    threshold=fval("vad_threshold", float, 0.5),
                    min_speech_duration_ms=fval(
                        "vad_min_speech_duration_ms", int, 250),
                    min_silence_duration_ms=fval(
                        "vad_min_silence_duration_ms", int, 100),
                    max_speech_duration_s=fval(
                        "vad_max_speech_duration_s", float, float("inf")),
                    speech_pad_ms=fval("vad_speech_pad_ms", int, 30),
                    samples_overlap=fval("vad_samples_overlap", float, 0.1))
                no_lang_probs = fval("no_language_probabilities", fbool,
                                     False)

                stereo = None
                if diarize:
                    data = _load_audio_bytes(fields["file"], stereo=True,
                                             convert=state.convert)
                    if data.ndim == 2 and data.shape[1] == 2:
                        stereo = data
                        audio = data.mean(axis=1)
                    else:
                        audio = data if data.ndim == 1 else data[:, 0]
                else:
                    audio = _load_audio_bytes(fields["file"],
                                              convert=state.convert)

                res, tr = state.run(p, audio)

                from ..cli import outputs as O

                def txt():
                    buf = io.StringIO()
                    O.write_txt(res, buf, stereo)   # = output_str
                    return buf.getvalue()

                if response_format == "text":
                    self._send(200, txt(),
                               ctype="text/html; charset=utf-8")
                elif response_format == "srt":
                    buf = io.StringIO()
                    O.write_srt(res, buf, stereo, offset_n=offset_n)
                    self._send(200, buf.getvalue(), ctype="application/x-subrip")
                elif response_format == "vtt":
                    buf = io.StringIO()
                    O.write_vtt(res, buf, stereo)
                    self._send(200, buf.getvalue(), ctype="text/vtt")
                elif response_format == "verbose_json":
                    from ..compat import whisper_lang_str_full
                    from ..decode import tokenizer as tok_mod
                    jres = {
                        "task": "translate" if p.translate else "transcribe",
                        "language": whisper_lang_str_full(
                            res.lang_id if res.lang_id >= 0
                            else tok_mod.lang_id(p.language or "en")),
                        "duration": len(audio) / 16000.0,
                        "text": txt(),
                        "segments": [],
                    }
                    if not no_lang_probs:
                        # language probabilities block (server.cpp:1051-1063)
                        from ..audio import mel as mel_mod
                        from ..decode import full as Fmod
                        with state.lock:   # serialize device access
                            mel = mel_mod.log_mel_spectrogram(
                                audio, tr.ctx.filters, device=tr.ctx.device)
                            lid, probs = Fmod.detect_language(tr.ctx, mel)
                        jres["detected_language"] = whisper_lang_str_full(lid)
                        jres["detected_language_probability"] = float(
                            probs[lid])
                        jres["language_probabilities"] = {
                            tok_mod.LANGUAGES[i][0]: float(probs[i])
                            for i in range(len(probs)) if probs[i] > 0.001}
                    for i, s in enumerate(res.segments):
                        seg = {"id": i, "text": s.text, "tokens": [],
                               "words": []}
                        if not p.no_timestamps:
                            seg["start"] = s.t0 / 100.0
                            seg["end"] = s.t1 / 100.0
                        total_logprob = 0.0
                        vocab = tr.ctx.vocab
                        for t in s.tokens:
                            if t.id >= vocab.token_eot:  # server.cpp:1081
                                continue
                            seg["tokens"].append(t.id)
                            word = {"word": vocab.token_to_str(t.id)}
                            if not p.no_timestamps:
                                word["start"] = t.t0 / 100.0
                                word["end"] = t.t1 / 100.0
                                word["t_dtw"] = t.t_dtw
                            word["probability"] = t.p
                            total_logprob += t.plog
                            seg["words"].append(word)
                        seg["temperature"] = p.temperature
                        seg["avg_logprob"] = (total_logprob
                                              / max(1, len(s.tokens)))
                        seg["no_speech_prob"] = s.no_speech_prob
                        jres["segments"].append(seg)
                    self._send(200, json.dumps(jres, ensure_ascii=False))
                else:
                    self._send(200, json.dumps({"text": txt()},
                                               ensure_ascii=False))
            except Exception as e:  # noqa: BLE001
                self._send(500, json.dumps({"error": str(e)}))

    return Handler


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8080,
          dtype=None, mesh=None, batch_window_ms: float = 0.0,
          max_batch: int = 8, vad_model: str | None = None,
          request_path: str = "", inference_path: str = "/inference",
          public_path: str | None = None, convert: bool = False,
          diarize_model: str | None = None,
          device: str | torch.device = "cuda"
          ) -> ThreadingHTTPServer:
    """`device`: the torch device the models run on (the card unless the
    caller asks for the CPU; raises without CUDA). `mesh` raises
    NotImplementedError: multi-device serving is not ported yet.
    `batch_window_ms` > 0 enables dynamic batching: concurrent greedy
    requests arriving within the window run as ONE lockstep device
    dispatch (RequestBatcher) instead of serializing behind the lock."""
    state = ServerState(model_path, dtype, mesh=mesh,
                        batch_window_ms=batch_window_ms, max_batch=max_batch,
                        vad_model=vad_model, request_path=request_path,
                        inference_path=inference_path,
                        public_path=public_path, convert=convert,
                        diarize_model=diarize_model, device=device)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    server.state = state        # introspection (tests, shutdown hooks)
    return server


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="whisper-server")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the model over all visible devices (not "
                         "ported yet: raises NotImplementedError)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel width within the mesh (not "
                         "ported yet: raises NotImplementedError)")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic batching: group concurrent greedy "
                         "requests arriving within this window into one "
                         "lockstep device dispatch (0 = off)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="max requests per batched dispatch")
    ap.add_argument("-vm", "--vad-model", default=None,
                    help="Silero VAD model for requests with vad=true")
    ap.add_argument("-dm", "--diarize-model", default=None,
                    help="SortFormer GGUF enabling POST /diarize")
    ap.add_argument("--request-path", default="",
                    help="prefix for all routes (server.cpp --request-path)")
    ap.add_argument("--inference-path", default="/inference")
    ap.add_argument("--public", default=None,
                    help="serve static files from this folder on GET")
    ap.add_argument("--convert", action="store_true",
                    help="transcode uploads to 16 kHz wav via ffmpeg")
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)
    if args.mesh or args.tp is not None:
        raise NotImplementedError(
            f"{'--mesh' if args.mesh else '--tp'}: serving on a mesh is not "
            "ported to the PyTorch package yet")
    if args.convert:
        import shutil
        if shutil.which("ffmpeg") is None:
            print("warning: --convert requested but ffmpeg was not found; "
                  "non-wav uploads will fail")
    server = serve(args.model, args.host, args.port,
                   batch_window_ms=args.batch_window_ms,
                   max_batch=args.max_batch, vad_model=args.vad_model,
                   request_path=args.request_path,
                   inference_path=args.inference_path,
                   public_path=args.public, convert=args.convert,
                   diarize_model=args.diarize_model,
                   device="cpu" if args.no_gpu else "cuda")
    print(f"whisper server listening on http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
