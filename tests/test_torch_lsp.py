"""The port's whisper language server (cli/lsp.py) against the JAX
package's on the CPU: framing, dispatch and error codes, commandsets in
both prompt modes, `guided` and `unguided` on the narrow f32 checkpoint of
`_torch_parity.write_checkpoint` (three decoder layers, tiny.en's
vocabulary of "<id>" pieces with the words of the commands and the guided
prompt from id 1000 on).

`unguided` runs with the sampled fallback off in both packages (it would
draw from torch's generator here and jax.random there): the requests'
JAX transcripts keep their tokens when the input is scaled by 1 + 2^-20.
"""

import base64
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import audio, write_checkpoint
from open_whisper_kit_tpu.cli import lsp as JL
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.models.whisper import model as JM
from open_whisper_kit_tpu_torch.cli import lsp as TL
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.models.whisper import model as TM

torch.set_num_threads(2)

COMMANDS = ["up", "down", "left", "right", "stop"]
WORDS = [b" up", b" down", b" left", b" right", b" stop", b" select", b" one", b" from",
         b" the", b" available", b" words", b":", b",", b".", b" Selected", b" word",
         b"up", b"down", b"left", b"right", b"stop", b" u", b" d"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("lsp") / "narrow.bin", words=WORDS)


@pytest.fixture(scope="module")
def servers(checkpoint):
    jctx = JF.WhisperContext.from_file(str(checkpoint), dtype=jnp.float32)
    tctx = TF.WhisperContext.from_file(str(checkpoint), dtype=torch.float32, device="cpu")
    return JL.LspServer(jctx), TL.LspServer(tctx)


@pytest.fixture
def no_fallback(monkeypatch):
    """Both packages' whisper_full with temperature_inc 0."""
    for mod in (JF, TF):
        def run(ctx, p, *a, _f=mod.whisper_full, **kw):
            p.temperature_inc = 0.0
            return _f(ctx, p, *a, **kw)
        monkeypatch.setattr(mod, "whisper_full", run)


def _rpc(method, params, rid=1):
    return {"jsonrpc": "2.0", "method": method, "params": params, "id": rid}


def _b64(x):
    return base64.b64encode(np.asarray(x, np.float32).tobytes()).decode()


def test_framing_roundtrip_and_headers():
    buf = io.BytesIO()
    TL._write_message(buf, {"jsonrpc": "2.0", "result": {"x": 1}, "id": 9})
    jbuf = io.BytesIO()
    JL._write_message(jbuf, {"jsonrpc": "2.0", "result": {"x": 1}, "id": 9})
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    assert TL._read_message(buf) == {"jsonrpc": "2.0", "result": {"x": 1}, "id": 9}
    body = json.dumps(_rpc("seek", {})).encode()
    raw = (b"Content-Length: %d\r\nContent-Type: application/json\r\n\r\n" % len(body)
           + body)
    assert TL._read_message(io.BytesIO(raw)) == _rpc("seek", {})
    assert TL._read_message(io.BytesIO(b"")) is None


@pytest.mark.parametrize("strict", [False, True])
def test_register_commandset_matches_jax(servers, strict):
    """The guided prompt's tokens in both modes (", "-joined words, or the
    reference's literal concatenation), the first tokens, the index."""
    jsrv, tsrv = servers
    jsrv.strict_prompt_parity = tsrv.strict_prompt_parity = strict
    try:
        rj = jsrv.handle(_rpc("registerCommandset", COMMANDS))
        rt = tsrv.handle(_rpc("registerCommandset", COMMANDS))
    finally:
        jsrv.strict_prompt_parity = tsrv.strict_prompt_parity = False
    assert rt == rj and "result" in rt
    assert tsrv.commandsets[-1] == jsrv.commandsets[-1]
    assert len({c["tokens"][0] for c in tsrv.commandsets[-1]["commands"]}) == len(COMMANDS)


def test_error_codes_match_jax(servers):
    jsrv, tsrv = servers
    fresh = TL.LspServer(tsrv.ctx), JL.LspServer(jsrv.ctx)
    cases = [{"jsonrpc": "1.0", "method": "unguided", "id": 5},
             _rpc("nosuch", {}), _rpc("seek", {}),
             _rpc("registerCommandset", ["up", "upward"]),
             _rpc("unguided", {"timestamp": 3}),
             _rpc("unguided", {"audio_b64": "AAA="})]
    for body in cases:
        assert tsrv.handle(body) == jsrv.handle(body), body
    assert fresh[0].handle(_rpc("guided", {})) == fresh[1].handle(_rpc("guided", {}))
    codes = [tsrv.handle(b)["error"]["code"] for b in cases]
    assert codes == [TL.INVALID_REQUEST, TL.METHOD_NOT_FOUND, TL.METHOD_NOT_FOUND,
                     TL.DUPLICATE_TOKEN, TL.INVALID_REQUEST, TL.WHISPER_FAILED]
    assert fresh[0].handle(_rpc("guided", {}))["error"]["code"] == TL.INVALID_REQUEST


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_guided_matches_jax(servers, monkeypatch, seed):
    """`guided` picks JAX's command on the same audio; the first-token
    probabilities it ranks agree within 1e-5."""
    jsrv, tsrv = servers
    rows = {}

    def record(mod, name, key):
        fn = getattr(mod, name)

        def run(*a, **kw):
            out = fn(*a, **kw)
            rows[key] = np.asarray(out[0].float() if key == "t" else out[0], np.float32)[0, 0]
            return out
        monkeypatch.setattr(mod, name, run)
    record(JM, "decode", "j")
    record(TM, "decode_impl", "t")
    for srv in servers:
        if not srv.commandsets:
            srv.handle(_rpc("registerCommandset", COMMANDS))
    req = _rpc("guided", {"audio_b64": _b64(audio(2.0, seed)), "timestamp": 42,
                          "commandset_index": 0}, rid=2)
    rj, rt = jsrv.handle(req), tsrv.handle(req)
    assert rt == rj and rt["result"]["timestamp"] == 42
    first = [c["tokens"][0] for c in tsrv.commandsets[0]["commands"]]

    def probs(row):
        e = np.exp(row - row.max())
        return (e / e.sum())[first]
    np.testing.assert_allclose(probs(rows["t"]), probs(rows["j"]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("seconds,seed", [(3.0, 0), (6.0, 4)])
def test_unguided_matches_jax(servers, no_fallback, seconds, seed):
    """`unguided` transcribes one window to JAX's text (single segment,
    32 tokens at most), with a prompt and without."""
    for params in ({}, {"prompt": "select one word", "timestamp": 7}):
        req = _rpc("unguided", {"audio_b64": _b64(audio(seconds, seed)), **params})
        rj, rt = servers[0].handle(req), servers[1].handle(req)
        assert rt == rj and rt["result"]["transcription"]


def test_main_serves_stdio_on_the_cpu(checkpoint, no_fallback, monkeypatch):
    """main -ng: framed requests on stdin, framed responses on stdout, equal
    to a server's own responses on the checkpoint loaded as main loads it
    (bf16, the CPU)."""
    reqs = [_rpc("registerCommandset", COMMANDS, 1),
            _rpc("guided", {"audio_b64": _b64(audio(2.0, 1))}, 2),
            _rpc("unguided", {"audio_b64": _b64(audio(3.0, 0))}, 3),
            _rpc("seek", {}, 4)]
    stdin = io.BytesIO()
    for r in reqs:
        TL._write_message(stdin, r)
    stdin.seek(0)
    out = io.BytesIO()
    monkeypatch.setattr("sys.stdin", type("S", (), {"buffer": stdin})())
    monkeypatch.setattr("sys.stdout", type("S", (), {"buffer": out})())
    assert TL.main(["-m", str(checkpoint), "-ng"]) == 0
    out.seek(0)
    got = [TL._read_message(out) for _ in reqs]
    srv = TL.LspServer(TF.WhisperContext.from_file(str(checkpoint), device="cpu"))
    assert got == [srv.handle(r) for r in reqs]
    assert "result" in got[1] and got[2]["result"]["transcription"]
    assert TL.build_parser().parse_args(["-m", "a"]).no_gpu is False
