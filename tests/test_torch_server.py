"""The port's HTTP server (server/http_server.py) on the CPU: every route
held to the port's own direct calls on the same checkpoint, a few
responses to the JAX package's server, and the request batcher held to a
direct lockstep call.

The checkpoint is the narrow f32 weights of `_torch_parity.contexts`
(three decoder layers) written as a ggml-bin. Requests set
`temperature_inc=0`: a sampled fallback draws from torch's global
generator, so two runs of one request could differ. The 25 s request
(audio seed 2, six segments) keeps its JAX transcript when the input is
scaled by 1 +- 2^-20, 2^-16 and 2^-13.
"""

import dataclasses
import io
import json
import shutil
import threading
import urllib.error
import urllib.parse
import urllib.request
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.server import http_server as JH
from open_whisper_kit_tpu_torch import api as TAPI
from open_whisper_kit_tpu_torch.audio import mel as TMEL
from open_whisper_kit_tpu_torch.audio.wav import load_wav
from open_whisper_kit_tpu_torch.cli import outputs as O
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import stream as TS
from open_whisper_kit_tpu_torch.decode.batch import transcribe_chunks_with_timings
from open_whisper_kit_tpu_torch.decode.params import FullParams, SamplingStrategy
from open_whisper_kit_tpu_torch.parallel.dp import _batch_route_eligible
from open_whisper_kit_tpu_torch.models.sortformer import export as TE
from open_whisper_kit_tpu_torch.models.sortformer import model as TSM
from open_whisper_kit_tpu_torch.server import http_server as TH

from _torch_parity import write_checkpoint

torch.set_num_threads(2)

TINY = TSM.SortformerConfig(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                            ff_expansion=2, subsampling_channels=8,
                            tf_layers=2, tf_d_model=16, tf_heads=4, tf_ff=32)


def wav_bytes(seconds: float, seed: int, channels: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((int(16000 * seconds), channels)) * 0.1
    if channels == 2:
        x[:, 1] *= 0.01          # the left channel carries the energy
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def decoded(data: bytes, tmp_path, stereo: bool = False) -> np.ndarray:
    path = tmp_path / "req.wav"
    path.write_bytes(data)
    return load_wav(path, stereo=stereo)


def multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "testboundary42"
    parts = []
    for k, v in fields.items():
        parts.append(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'.encode()
            + (b'; filename="a.wav"' if k == "file" else b"") + b"\r\n\r\n"
            + (v if isinstance(v, bytes) else str(v).encode()) + b"\r\n")
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f'multipart/form-data; boundary="{boundary}"')


def post(url: str, body: bytes, ctype: str, timeout: float = 300):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode(), r.headers.get("Content-Type")


def infer(url: str, fields: dict, path: str = "/inference"):
    return post(url + path, *multipart({"temperature_inc": b"0", **fields}))


def start(srv) -> str:
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from open_whisper_kit_tpu_torch.io import silero_writer as SW
    d = tmp_path_factory.mktemp("srv")
    SW.write_silero(d / "silero.bin", SW.random_silero_tensors(seed=0))
    return {"model": str(write_checkpoint(d / "narrow-f32.bin")),
            "diarize": str(TE.write_sortformer_gguf(
                d / "tiny-sortformer.gguf", TINY, TSM.init_params(TINY, seed=0, device="cpu"))),
            "vad": str(d / "silero.bin")}


@pytest.fixture(scope="module")
def server(files):
    srv = TH.serve(files["model"], port=0, dtype=torch.float32, device="cpu",
                   diarize_model=files["diarize"], vad_model=files["vad"])
    yield start(srv), srv
    srv.shutdown()


@pytest.fixture(scope="module")
def direct(files):
    return TAPI.Transcriber(model_path=files["model"], dtype=torch.float32, device="cpu")


def handler_params(**kw) -> FullParams:
    """The FullParams the /inference handler builds from an otherwise
    empty form with temperature_inc=0."""
    p = FullParams(print_progress=False, language="en", temperature_inc=0.0, max_len=60)
    p.greedy = dataclasses.replace(p.greedy, best_of=2)
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def test_health(server):
    with urllib.request.urlopen(f"{server[0]}/health") as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_inference_formats_equal_direct(server, direct, tmp_path):
    """text, json, srt (with offset_n), vtt and verbose_json of a 25 s
    request: each the port's writers over a direct Transcriber.full."""
    wav = wav_bytes(25, 2)
    audio = decoded(wav, tmp_path)
    res = direct.full(handler_params(), audio)
    assert len(res.segments) >= 4

    def text(writer, **kw):
        buf = io.StringIO()
        writer(res, buf, None, **kw)
        return buf.getvalue()

    url = server[0]
    assert infer(url, {"file": wav, "response_format": b"text"})[1:] == (
        text(O.write_txt), "text/html; charset=utf-8")
    assert json.loads(infer(url, {"file": wav})[1]) == {"text": text(O.write_txt)}
    assert infer(url, {"file": wav, "response_format": b"srt", "offset_n": b"7"})[1] == \
        text(O.write_srt, offset_n=7)
    assert infer(url, {"file": wav, "response_format": b"vtt"})[1] == text(O.write_vtt)
    got = json.loads(infer(url, {"file": wav, "response_format": b"verbose_json"})[1])
    want = direct.full(handler_params(token_timestamps=True), audio)
    assert [s["text"] for s in got["segments"]] == [s.text for s in want.segments]
    assert [(s["start"], s["end"]) for s in got["segments"]] == [
        (s.t0 / 100.0, s.t1 / 100.0) for s in want.segments]
    assert [[(w["start"], w["end"]) for w in s["words"]] for s in got["segments"]] == [
        [(t.t0 / 100.0, t.t1 / 100.0) for t in s.tokens if t.id < direct.ctx.vocab.token_eot]
        for s in want.segments]
    assert got["language"] == "english" and got["duration"] == 25.0
    lid, probs = TF.detect_language(direct.ctx, TMEL.log_mel_spectrogram(
        audio, direct.ctx.filters, device="cpu"))
    assert got["detected_language_probability"] == float(probs[lid])


def close_json(a, b, path=""):
    """Equal JSON trees, floats within 1e-5 (probabilities from torch and
    from XLA); language maps compared on the keys both sides list, and a
    key one side lacks only within 1e-5 of the 0.001 cut."""
    if isinstance(a, dict) and isinstance(b, dict):
        if path.endswith("language_probabilities"):
            for k in set(a) ^ set(b):
                assert abs(a.get(k, b.get(k)) - 0.001) <= 1e-5, (path, k)
            keys = set(a) & set(b)
        else:
            assert set(a) == set(b), path
            keys = a
        for k in keys:
            close_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-5, (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_responses_equal_jax_server(server, files):
    """json, srt, verbose_json and /detect-language against the JAX
    package's server on the same checkpoint: ids, texts and times exact,
    probabilities within 1e-5."""
    srv = JH.serve(files["model"], port=0, dtype=jnp.float32)
    jurl = start(srv)
    try:
        wav = wav_bytes(25, 2)
        for fmt in (b"json", b"srt", b"verbose_json"):
            got = infer(server[0], {"file": wav, "response_format": fmt})[1]
            want = infer(jurl, {"file": wav, "response_format": fmt})[1]
            if fmt == b"srt":
                assert got == want
            else:
                close_json(json.loads(got), json.loads(want))
        short = multipart({"file": wav_bytes(5, 4)})
        close_json(json.loads(post(server[0] + "/detect-language", *short)[1]),
                   json.loads(post(jurl + "/detect-language", *short)[1]))
    finally:
        srv.shutdown()


def test_detect_language_equals_direct(server, direct, tmp_path):
    wav = wav_bytes(5, 4)
    got = json.loads(post(server[0] + "/detect-language", *multipart({"file": wav}))[1])
    lid, probs = direct.detect_language(decoded(wav, tmp_path))
    assert got["probability"] == float(probs[lid])
    assert got["language_probabilities"] == {
        k: float(p) for k, p in zip([l[0] for l in TF.tok_mod.LANGUAGES], probs) if p > 0.001}


@pytest.mark.parametrize("fmt,seconds", [("s16le", 12), ("f32le", 6.5)])
def test_stream_session_equals_in_process_transcriber(server, direct, fmt, seconds):
    """/stream/start -> 0.5 s pieces of PCM -> /stream/finish: the events of
    an in-process StreamingTranscriber fed the same pieces."""
    url = server[0]
    cfg = {"step_ms": 3000, "length_ms": 10000, "keep_ms": 200, "keep_context": True}
    sid = json.loads(post(url + "/stream/start", json.dumps(cfg).encode(),
                          "application/json")[1])["session"]
    st = TS.StreamingTranscriber(direct.ctx, TS.StreamParams(
        step_ms=3000, length_ms=10000, keep_ms=200, no_context=False, no_fallback=True))
    x = (np.random.default_rng(6).standard_normal(int(16000 * seconds)) * 0.1
         ).astype(np.float32)
    pcm = (x * 32767).astype("<i2") if fmt == "s16le" else x.astype("<f4")
    got, want = [], []
    pieces = [pcm[i:i + 8000] for i in range(0, len(pcm), 8000)]
    for i, piece in enumerate(pieces):
        route = "finish" if i == len(pieces) - 1 else "feed"
        got += json.loads(post(f"{url}/stream/{route}?session={sid}&format={fmt}",
                               piece.tobytes(), "application/octet-stream")[1])["events"]
        f = (piece.astype(np.float32) / 32768.0 if fmt == "s16le"
             else piece.astype(np.float32))
        want += st.feed(f) + (st.flush() if route == "finish" else [])
    assert got == [{"text": e.text, "t0": e.t0, "t1": e.t1, "final": e.final,
                    "speaker_turn_next": e.speaker_turn_next} for e in want]
    assert len(got) >= seconds // 3 and sid not in server[1].state.sessions


def test_stream_unknown_session(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server[0] + "/stream/feed?session=nope", b"\0\0", "application/octet-stream")
    assert e.value.code == 404


def test_diarize_route_equals_diarizer(server, files, tmp_path):
    """/diarize with the TINY SortFormer: JSON segments and RTTM text of
    Diarizer.diarize on the same audio."""
    from open_whisper_kit_tpu_torch.align import rttm as R
    wav = wav_bytes(12, 8)
    _, segs = TAPI.Diarizer(model_path=files["diarize"], device="cpu").diarize(
        decoded(wav, tmp_path), threshold=0.4, file_id="clip")
    assert segs
    fields = {"file": wav, "threshold": b"0.4", "file_id": b"clip"}
    got = json.loads(post(server[0] + "/diarize", *multipart(fields))[1])
    assert got == {"segments": [{"speaker": s.speaker, "start": s.start,
                                 "duration": s.duration} for s in segs]}
    assert post(server[0] + "/diarize", *multipart({**fields, "response_format": b"rttm"}))[1] \
        == R.to_rttm(segs)


def test_load_in_each_body_layout(server, files):
    """/load as JSON, as a urlencoded form and as multipart (the bindings'
    layouts); the server still answers afterwards."""
    url, srv = server
    m = files["model"]
    for body, ctype in ((json.dumps({"model": m}).encode(), "application/json"),
                        (("model=" + urllib.parse.quote(m)).encode(),
                         "application/x-www-form-urlencoded"),
                        multipart({"model": m.encode()})):
        tr = srv.state.transcriber
        assert post(url + "/load", body, ctype)[:2] == (200, '{"status": "ok"}')
        assert srv.state.transcriber is not tr
        assert srv.state.transcriber.ctx.device == torch.device("cpu")
    with pytest.raises(urllib.error.HTTPError) as e:
        post(url + "/load", b"{}", "application/json")
    assert e.value.code == 500


def test_binding_multipart_layouts(server):
    """The bodies bindings/{ruby,java} and bindings/go write parse."""
    url = server[0]
    wav = wav_bytes(1, 0)
    b = "owk-ruby-boundary"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"t.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + wav + (
        f"\r\n--{b}\r\nContent-Disposition: form-data; name=\"response_format\"\r\n\r\n"
        f"json\r\n--{b}--\r\n").encode()
    status, out, _ = post(url + "/inference", body, f"multipart/form-data; boundary={b}")
    assert status == 200 and "text" in json.loads(out)
    b = "gob0undary"
    parts = [f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"a.wav\"\r\n"
             "Content-Type: application/octet-stream\r\n\r\n".encode() + wav,
             f"--{b}\r\nContent-Disposition: form-data; name=\"temperature\"\r\n\r\n0.0".encode(),
             f"--{b}\r\nContent-Disposition: form-data; name=\"response_format\"\r\n\r\ntext"
             .encode()]
    body = b"\r\n".join(parts) + f"\r\n--{b}--\r\n".encode()
    assert post(url + "/inference", body, f"multipart/form-data; boundary={b}")[0] == 200
    with pytest.raises(urllib.error.HTTPError) as e:
        post(url + "/inference", *multipart({"language": b"en"}))
    assert e.value.code == 400


def test_concurrent_requests_agree(server):
    """Four requests at once on the handler threads, one model: all answer,
    with one text."""
    body, ctype = multipart({"file": wav_bytes(8, 5), "temperature_inc": b"0"})
    results, errors = [], []

    def hit():
        try:
            results.append(json.loads(post(server[0] + "/inference", body, ctype)[1]))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 4 and len({r["text"] for r in results}) == 1


def test_stereo_diarize_speaker_prefix(server):
    """diarize=true on a stereo upload: channel-energy speaker labels."""
    out = infer(server[0], {"file": wav_bytes(16, 5, channels=2), "response_format": b"text",
                            "diarize": b"true"})[1]
    assert "(speaker 0)" in out


def test_request_path_inference_path_and_public_files(files, tmp_path):
    pub = tmp_path / "public"
    pub.mkdir()
    (pub / "index.html").write_text("<html>demo</html>")
    (pub / "app.js").write_text("var x = 1;")
    srv = TH.serve(files["model"], port=0, dtype=torch.float32, device="cpu",
                   request_path="/v1", inference_path="/transcribe", public_path=str(pub))
    url = start(srv)
    try:
        with urllib.request.urlopen(f"{url}/v1/health?probe=1") as r:
            assert json.loads(r.read()) == {"status": "ok"}
        assert "text" in json.loads(infer(url, {"file": wav_bytes(2, 1)}, "/v1/transcribe")[1])
        for bad in (lambda: infer(url, {"file": wav_bytes(2, 1)}),
                    lambda: urllib.request.urlopen(f"{url}/other/health"),
                    lambda: urllib.request.urlopen(f"{url}/v1/../../etc/passwd")):
            with pytest.raises(urllib.error.HTTPError) as e:
                bad()
            assert e.value.code == 404
        for path in ("/v1/", "/v1/%69ndex.html"):
            with urllib.request.urlopen(url + path) as r:
                assert b"demo" in r.read()
        with urllib.request.urlopen(f"{url}/v1/app.js") as r:
            assert r.headers.get("Content-Type").startswith(("text/javascript",
                                                             "application/javascript"))
    finally:
        srv.shutdown()


def test_convert_without_ffmpeg_errors_cleanly(files):
    if shutil.which("ffmpeg"):
        pytest.skip("ffmpeg present; conversion would succeed")
    srv = TH.serve(files["model"], port=0, dtype=torch.float32, device="cpu", convert=True)
    url = start(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            infer(url, {"file": wav_bytes(1, 0)})
        assert e.value.code == 500 and "ffmpeg" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()


@pytest.fixture(scope="module")
def batched(files):
    srv = TH.serve(files["model"], port=0, dtype=torch.float32, device="cpu",
                   batch_window_ms=300.0, max_batch=4)
    yield start(srv), srv
    srv.shutdown()


def test_batched_requests_equal_direct_lockstep(batched, direct, tmp_path):
    """Three concurrent srt requests ride one lockstep group; each response
    is the port's writer over a direct transcribe_chunks_with_timings of
    the three."""
    url, srv = batched
    wavs = [wav_bytes(25 if s == 3 else 4, s) for s in (1, 2, 3)]
    out, errs = [None] * 3, []

    def hit(i):
        try:
            out[i] = infer(url, {"file": wavs[i], "response_format": b"srt"})[1]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and srv.state.batcher.max_group == 3
    segs, _ = transcribe_chunks_with_timings(
        direct.ctx, handler_params(), [decoded(w, tmp_path) for w in wavs])
    for got, want in zip(out, segs):
        buf = io.StringIO()
        O.write_srt(TF.TranscribeResult(segments=want), buf)
        assert got == buf.getvalue()
    assert sum(got.count("-->") for got in out) >= 6


def test_ineligible_requests_fall_back_to_the_serial_path(batched, server):
    """Beam search is not lockstep-eligible: the batcher runs it as the
    serial server does, with the same response, and groups nothing."""
    url, srv = batched
    n0 = srv.state.batcher.n_dispatches
    fields = {"file": wav_bytes(4, 9), "response_format": b"verbose_json", "beam_size": b"2"}
    got = json.loads(infer(url, fields)[1])
    assert got["segments"] == json.loads(infer(server[0], fields)[1])["segments"]
    assert srv.state.batcher.n_dispatches == n0


# every FullParams field the /inference handler sets, with a value a form
# can give it ("a.b" is field b of the sub-dataclass a)
HANDLER_FIELDS = [
    ("language", "de"), ("translate", True), ("temperature", 0.4),
    ("temperature_inc", 0.1), ("no_timestamps", True), ("audio_ctx", 750),
    ("initial_prompt", "hi"), ("suppress_nst", True), ("tdrz_enable", True),
    ("entropy_thold", 2.8), ("logprob_thold", -0.5), ("max_len", 30),
    ("split_on_word", True), ("n_max_text_ctx", 64), ("duration_ms", 1000),
    ("debug_mode", True), ("detect_language", True), ("offset_ms", 500),
    ("strategy", SamplingStrategy.BEAM_SEARCH), ("thold_pt", 0.02),
    ("token_timestamps", True), ("vad", True), ("vad_model_path", "v.bin"),
    ("greedy.best_of", 5), ("beam_search.beam_size", 3),
    ("vad_params", "threshold=0.7")]
# fields read only when the field named beside them is set, which turns
# the request away from the lockstep route
READ_ONLY_UNDER = {"thold_pt": "token_timestamps", "vad_model_path": "vad",
                   "vad_params": "vad", "beam_search.beam_size": "strategy"}


def with_field(p, field, value):
    if field == "vad_params":
        k, v = value.split("=")
        p.vad_params = dataclasses.replace(p.vad_params, **{k: float(v)})
    elif "." in field:
        sub, name = field.split(".")
        setattr(p, sub, dataclasses.replace(getattr(p, sub), **{name: value}))
    else:
        setattr(p, field, value)
    return p


@pytest.mark.parametrize("field,value", HANDLER_FIELDS)
def test_batch_key_lists_every_field_the_handler_sets(field, value):
    """Each handler field splits the batch key, or turns the request away
    from the lockstep route, or is read only under a field that does (and
    then splits no eligible group): requests grouped together decode
    alike, and no field the lockstep decode ignores costs batching."""
    p, q = handler_params(), with_field(handler_params(), field, value)
    assert _batch_route_eligible(None, p)
    split = TH.RequestBatcher._key(p) != TH.RequestBatcher._key(q)
    if field in READ_ONLY_UNDER:
        gate = READ_ONLY_UNDER[field]
        assert not split and _batch_route_eligible(None, q)
        assert not _batch_route_eligible(None, with_field(q, gate, dict(HANDLER_FIELDS)[gate]))
    else:
        assert split or not _batch_route_eligible(None, q)


def test_handler_sets_only_the_listed_fields():
    import inspect
    import re
    set_here = set(re.findall(r"\bp\.(\w+(?:\.\w+)?) = ", inspect.getsource(TH)))
    assert set_here == {f for f, _ in HANDLER_FIELDS}


def test_mesh_raises_and_names_itself(files):
    with pytest.raises(NotImplementedError, match="mesh"):
        TH.serve(files["model"], port=0, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="--mesh"):
        TH.main(["-m", files["model"], "--mesh", "-ng"])
    with pytest.raises(NotImplementedError, match="--tp"):
        TH.main(["-m", files["model"], "--tp", "2", "-ng"])


def test_multipart_keeps_a_payload_s_trailing_cr_lf_bytes(server):
    """An upload whose last bytes are CR LF keeps them (JAX's parser strips
    every trailing CR / LF byte of a part, so such a WAV's last sample is
    cut and the decode fails): only the framing's CRLF goes."""
    value = b"RIFF\x00\r\n\r\n"
    body, ctype = multipart({"file": value, "response_format": b"json"})
    assert TH._parse_multipart(body, ctype) == {"file": value, "response_format": b"json"}
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.full(16000, 0x0A0D, "<i2").tobytes())   # ends in 0d 0a
    assert buf.getvalue().endswith(b"\r\n")
    assert "text" in json.loads(infer(server[0], {"file": buf.getvalue()})[1])
