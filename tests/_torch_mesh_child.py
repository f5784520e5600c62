"""One rank of the multi-process CPU tests of the port's mesh code
(tests/test_torch_mesh.py, test_torch_decode_tp.py, test_torch_multiprocess.py).

    python tests/_torch_mesh_child.py SCENARIO RANK WORLD PORT OUT [CKPT]

Every rank joins one Gloo group over 127.0.0.1:PORT, runs SCENARIO and,
on rank 0, pickles its results to OUT/SCENARIO.pkl; each request is also
run on rank 0 without a mesh, in this process, with the same thread count,
as the one-process reference. Imports torch and the port, never jax.
"""

import io
import json
import pickle
import sys
import threading
import urllib.request
import wave
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from open_whisper_kit_tpu_torch.api import Transcriber  # noqa: E402
from open_whisper_kit_tpu_torch.decode.params import FullParams, SamplingStrategy  # noqa: E402
from open_whisper_kit_tpu_torch.models.whisper import model as TM  # noqa: E402
from open_whisper_kit_tpu_torch.ops import decode_tp as DTP  # noqa: E402
from open_whisper_kit_tpu_torch.parallel import mesh as X  # noqa: E402

torch.set_num_threads(1)

# the decode_tp tests' decoder: six 64-wide heads (tp 2 and 3 divide them)
TP_CFG = TM.WhisperConfig(n_vocab=640, n_audio_ctx=48, n_audio_state=384, n_audio_head=6,
                          n_audio_layer=1, n_text_ctx=64, n_text_state=384, n_text_head=6,
                          n_text_layer=2, n_mels=80)


def audio(seconds: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def greedy() -> FullParams:
    p = FullParams(print_progress=False)
    p.temperature_inc = 0.0
    return p


def beam2() -> FullParams:
    p = FullParams(print_progress=False, strategy=SamplingStrategy.BEAM_SEARCH)
    p.beam_search.beam_size = 2
    p.temperature_inc = 0.0
    return p


def ids(res):
    return [t.id for s in res.segments for t in s.tokens]


def times(res):
    return [(s.t0, s.t1) for s in res.segments]


REQUESTS = {
    "greedy 35 s": lambda tr: tr.transcribe(audio(35.0, 0), greedy()),
    "greedy 25 s": lambda tr: tr.transcribe(audio(25.0, 2), greedy()),
    "beam 2, 25 s": lambda tr: tr.transcribe(audio(25.0, 2), beam2()),
    "batched 50 s, 2 chunks": lambda tr: tr.transcribe_batched(audio(50.0, 4), greedy(),
                                                              n_chunks=2),
    "full_parallel 50 s, 2": lambda tr: tr.full_parallel(greedy(), audio(50.0, 4), 2),
}

# the requests each mesh runs (the mesh's shape in its name)
MESH_REQUESTS = {
    "tp2": ("greedy 35 s", "beam 2, 25 s"),
    "dp2": ("batched 50 s, 2 chunks", "full_parallel 50 s, 2"),
    "dp2 tp2": ("full_parallel 50 s, 2",),
    "tp4": ("greedy 25 s",),
}


def requests(tr, names):
    """{name: (token ids, segment times)} of the named requests on `tr`."""
    out = {}
    for name in names:
        res = REQUESTS[name](tr)
        out[name] = (ids(res), times(res))
    return out


def step_logits(tr):
    """One encoder pass and one decoder step (test_multihost's sharded
    step): the logits."""
    ctx = tr.ctx
    mel = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2 * ctx.cfg.n_audio_ctx, ctx.cfg.n_mels)).astype(np.float32))
    _, xk, xv = ctx.encode_window(mel, 0, 0)
    kv_k, kv_v = TM.init_kv_cache(ctx.cfg, 1, ctx.dtype, device="cpu")
    toks = torch.tensor([[ctx.vocab.token_sot, 7, 11]])
    logits, _, _ = TM.decode_impl(ctx.cfg, ctx.params["decoder"], toks, kv_k, kv_v, 0, xk, xv)
    return logits.numpy()


def wav_bytes(x: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def serve_on(mesh, ckpt: str, x: np.ndarray) -> dict:
    """Rank 0 serves on `mesh` and asks /health and one /inference (the
    other ranks follow); returns rank 0's answers."""
    from open_whisper_kit_tpu_torch.server import http_server as TH
    if dist.get_rank() != 0:
        TH.ServerState(ckpt, dtype=torch.float32, mesh=mesh, device="cpu").follow()
        return {}
    srv = TH.serve(ckpt, port=0, dtype=torch.float32, mesh=mesh, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        boundary = "meshboundary"
        body = b"".join(
            f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'.encode()
            + (b'; filename="a.wav"' if k == "file" else b"") + b"\r\n\r\n"
            + (v if isinstance(v, bytes) else v.encode()) + b"\r\n"
            for k, v in (("file", wav_bytes(x)), ("temperature_inc", "0"),
                         ("response_format", "json"))) + f"--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            base + "/inference", data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=300) as r:
            inference = (r.status, json.loads(r.read()))
    finally:
        srv.shutdown()
        srv.state.close()
    return {"health": health, "inference": inference}


def decoded_wav(x: np.ndarray) -> np.ndarray:
    """x as the server reads it back from the 16-bit WAV it was sent as."""
    with wave.open(io.BytesIO(wav_bytes(x))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0


def scenario_mesh(world: int, ckpt: str) -> dict:
    """The (dp, tp) meshes of `world` ranks: the requests and one sharded
    step against one process, and (world 2) the server."""
    out = {"world": world}
    rank = dist.get_rank()
    mesh = X.make_mesh(device="cpu")
    dp_mesh = X.make_mesh(tp=1, device="cpu")
    if world == 2:
        meshes = {"tp2": mesh, "dp2": dp_mesh}
    else:
        meshes = {"dp2 tp2": mesh, "tp4": X.make_mesh(tp=4, device="cpu")}
    out["shapes"] = {k: tuple(m.mesh.shape) for k, m in meshes.items()}
    out["requests"], out["logits"], out["qkv_shape"] = {}, {}, {}
    for name, m in meshes.items():
        tr = Transcriber(model_path=ckpt, dtype=torch.float32, device="cpu", mesh=m)
        out["qkv_shape"][name] = tuple(tr.ctx.params["decoder"]["blocks"]["qkv_w"].shape)
        out["requests"][name] = requests(tr, MESH_REQUESTS[name])
        out["logits"][name] = step_logits(tr)
    out["collectives"] = dict(X.COLLECTIVES)
    x = audio(8.0, 5)
    if world == 2:
        out["server"] = serve_on(mesh, ckpt, x)
    # the one-process references, shared out over the ranks
    ref = Transcriber(model_path=ckpt, dtype=torch.float32, device="cpu")
    names = sorted({n for m in meshes for n in MESH_REQUESTS[m]})
    mine = requests(ref, names[rank::world])
    if rank == 0:
        out["ref_logits"] = step_logits(ref)
        out["ref_qkv_shape"] = tuple(ref.ctx.params["decoder"]["blocks"]["qkv_w"].shape)
        out["ref_server_text"] = ref.transcribe(decoded_wav(x), greedy()).text
    parts = [None] * world
    dist.all_gather_object(parts, mine)
    out["ref_requests"] = {k: v for part in parts for k, v in part.items()}
    return out


def scenario_basics(world: int) -> dict:
    """make_mesh's defaults and shapes, the collectives, fetch_np, and
    shard_context_params on each rank of the real mesh."""
    rank = dist.get_rank()
    mesh = X.make_mesh(device="cpu")
    out = {"world": world, "default": tuple(mesh.mesh.shape), "names": mesh.mesh_dim_names,
           "shapes": {tp: tuple(X.make_mesh(tp=tp, device="cpu").mesh.shape)
                      for tp in (1, world)}}
    if world % 4 == 0:
        m3 = X.make_mesh3(device="cpu")
        out["mesh3"] = (tuple(m3.mesh.shape), m3.mesh_dim_names, X.seq_sharding(m3))
    group = mesh.get_group("tp")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    dp_mesh = X.make_mesh(tp=1, device="cpu")
    mine = {"coord": (X.axis_rank(mesh, "dp"), X.axis_rank(mesh, "tp")),
            "gather": X.all_gather_last(x, group).numpy(),
            "gather_bf16": X.all_gather_last(x.bfloat16(), group).float().numpy(),
            "reduce": X.all_reduce_sum(x, group).numpy(),
            "fetch": X.fetch_np(torch.full((1, 2), rank), dp_mesh),
            "fetch_list": X.fetch_np([rank], dp_mesh)}
    # mha_full_tp on whole q/k/v: heads over tp, the batch of 2 over dp
    from open_whisper_kit_tpu_torch.ops import attention as A
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 64, 256, generator=g) for _ in range(3))
    mine["mha_tp"] = (A.mha_full_tp(q, k, v, 4, 0.125, mesh, kv_valid=60)
                      - A.mha_full(q, k, v, 4, 0.125, kv_valid=60)).abs().max().item()
    cfg = TM.WhisperConfig(51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)
    params = TM.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params["decoder"] = TM.prepare_decoder(params["decoder"])
    sh = X.shard_context_params(params, cfg, mesh)
    mine["shards"] = {k: sh["decoder"]["blocks"][k].numpy() for k in ("qkv_w", "o_w", "qkv_b")}
    mine["whole"] = X.gather_context_params(sh, cfg)["decoder"]["blocks"]["qkv_w"].numpy()
    # a quantized decoder: its layers (planes and biases) stay whole, and
    # gathering gives back every leaf as it was
    q = dict(params, decoder=TM.quantize_decoder_int8(params["decoder"], scope="all"))
    back = X.gather_context_params(X.shard_context_params(q, cfg, mesh), cfg)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, torch.Tensor):
            return a.shape == b.shape and bool(a.equal(b))
        return a.qs.equal(b.qs) and a.scales.equal(b.scales)
    mine["quant_roundtrip"] = same(q, back)
    parts = [None] * world
    dist.all_gather_object(parts, mine)
    out["ranks"] = parts
    out["collectives"] = dict(X.COLLECTIVES)
    return out


def tp_decoder():
    params = TM.init_params(TP_CFG, seed=0, dtype=torch.bfloat16, device="cpu")
    dec = TM.prepare_decoder(params["decoder"])
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(rng.standard_normal((1, TP_CFG.n_audio_ctx, TP_CFG.n_audio_state))
                           .astype(np.float32)).bfloat16()
    xk, xv = TM.cross_kv(TP_CFG, dec, enc)
    return dec, xk[:, 0], xv[:, 0]


def tp_steps(dec, xk, xv, tp: int, group, rank: int):
    """Three one-row steps and one three-row step at kv_head 4 on fresh
    caches: (logits of each, the caches after each run), this rank's
    columns of the caches."""
    S, L, Tc = TP_CFG.n_text_state, TP_CFG.n_text_layer, 32
    mp = DTP.shard_mega_tp(DTP.prepare_mega_tp(TP_CFG, dec, tp), rank)
    cols = slice(rank * S // tp, (rank + 1) * S // tp)
    xkl, xvl = xk[..., cols].contiguous(), xv[..., cols].contiguous()
    g = np.random.default_rng(9)
    out = []
    for heads in (((1, 0), (1, 1), (1, 2)), ((3, 4),)):
        kv_k = torch.zeros(L, Tc, S // tp, dtype=torch.bfloat16)
        kv_v = torch.zeros_like(kv_k)
        logits = []
        for R, head in heads:
            x0 = torch.from_numpy(g.standard_normal((R, S)).astype(np.float32) * 0.1).bfloat16()
            lg, kv_k, kv_v = DTP.mega_decode_step_tp(TP_CFG, mp, x0, kv_k, kv_v, head,
                                                     xkl, xvl, group=group)
            logits.append(lg.float().numpy())
        out.append((logits, kv_k.float().numpy(), kv_v.float().numpy()))
    return out


def scenario_tp(world: int) -> dict:
    """The decode_tp step at tp = world against tp = 1; the K3 calls'
    splits (a spy on the module's qmm) at both."""
    rank = dist.get_rank()
    dec, xk, xv = tp_decoder()
    calls = []
    qmm = DTP.qmm

    def spy(x, qs, scales, splits=None):
        calls.append((x.shape[0], qs.shape[0], splits))
        return qmm(x, qs, scales, splits=splits)
    DTP.qmm = spy
    got = tp_steps(dec, xk, xv, world, dist.group.WORLD, rank)
    out = {"world": world, "calls": list(calls)}
    gathered = [None] * world
    dist.all_gather_object(gathered, got)
    out["ranks"] = gathered
    if rank == 0:
        calls.clear()
        out["ref"] = tp_steps(dec, xk, xv, 1, None, 0)
        out["ref_calls"] = list(calls)
    DTP.qmm = qmm
    return out


def run_worlds(worlds: dict, out_dir, ckpt=None, timeout: float = 300.0) -> dict:
    """Start every world {scenario: ranks} at once, each rank a process of
    this script; wait for all, fail on a rank's error (its output in the
    message), kill every process on the way out. Returns {scenario: rank
    0's results}."""
    import socket
    import subprocess

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]
    procs = []
    try:
        for scenario, n in worlds.items():
            port = free_port()
            for rank in range(n):
                cmd = [sys.executable, __file__, scenario, str(rank), str(n), str(port),
                       str(out_dir)] + ([str(ckpt)] if ckpt else [])
                procs.append((scenario, rank, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        for scenario, rank, proc in procs:
            text = proc.communicate(timeout=timeout)[0].decode(errors="replace")
            assert proc.returncode == 0, f"{scenario} rank {rank}:\n{text[-4000:]}"
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for scenario in worlds:
        with open(Path(out_dir) / f"{scenario}.pkl", "rb") as f:
            out[scenario] = pickle.load(f)
    return out


def main() -> int:
    scenario, rank, world, port, out_dir = sys.argv[1:6]
    ckpt = sys.argv[6] if len(sys.argv) > 6 else None
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        if scenario.startswith("tp"):
            out = scenario_tp(world)
        elif scenario.startswith("basics"):
            out = scenario_basics(world)
        else:
            out = scenario_mesh(world, ckpt)
        if rank == 0:
            with open(Path(out_dir) / f"{scenario}.pkl", "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
