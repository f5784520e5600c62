"""Multi-process serving on Gloo (CPU): the port's counterparts of the JAX
package's test_mesh_api.py and test_multihost.py. Two and four processes
(tests/_torch_mesh_child.py, spawned once each for the module) build
Transcriber(mesh=) on the narrow f32 checkpoint of `_torch_parity`:

* transcribe (greedy 35 s, 148 tokens; 25 s), beam 2, transcribe_batched
  and full_parallel (50 s in two chunks) on (dp 1, tp 2), (dp 2, tp 1),
  (dp 2, tp 2) and (dp 1, tp 4) (two heads: whole heads on every rank) give
  the token ids and segment times of one process; one encoder pass and decoder step
  (test_multihost's sharded step) stay within 1e-5 of max|logit|;
* the server on (dp 1, tp 2) answers /health and one /inference as one
  process does;
* tools/launch_multihost.py runs end to end over two processes.

The requests are the ones tests/test_torch_server.py holds to the JAX
package (narrow f32, temperature_inc 0); the ranks' row-parallel sums meet
in another order than one process's, so the logits are not bit-equal (as
in JAX's multihost test); the tokens are.
"""

import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

import _torch_mesh_child as child
from _torch_parity import write_checkpoint

REPO = Path(__file__).resolve().parent.parent
# the tokens each request emits on the narrow checkpoint, at least
MIN_TOKENS = {"greedy 35 s": 148, "greedy 25 s": 12, "beam 2, 25 s": 16,
              "batched 50 s, 2 chunks": 20, "full_parallel 50 s, 2": 24}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("mp") / "narrow.bin")


@pytest.fixture(scope="module")
def worlds(ckpt, tmp_path_factory):
    return child.run_worlds({"mesh2": 2, "mesh4": 4}, tmp_path_factory.mktemp("mpout"),
                            ckpt=ckpt, timeout=600)


@pytest.mark.parametrize("world,mesh", [(2, "tp2"), (2, "dp2"), (4, "dp2 tp2"), (4, "tp4")])
def test_mesh_requests_equal_one_process(worlds, world, mesh):
    out = worlds[f"mesh{world}"]
    assert out["requests"][mesh], mesh
    for name, (ids, times) in out["requests"][mesh].items():
        ref_ids, ref_times = out["ref_requests"][name]
        assert ids == ref_ids, f"{mesh}: {name}"
        assert times == ref_times, f"{mesh}: {name}"
        assert len(ids) >= MIN_TOKENS[name], f"{mesh}: {name}"


@pytest.mark.parametrize("world,mesh", [(2, "tp2"), (2, "dp2"), (4, "dp2 tp2"), (4, "tp4")])
def test_sharded_step_matches_one_process(worlds, world, mesh):
    out = worlds[f"mesh{world}"]
    got, ref = out["logits"][mesh], out["ref_logits"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got / np.abs(ref).max(), ref / np.abs(ref).max(), atol=1e-5)


def test_mesh_shapes_and_weights(worlds):
    """The meshes' shapes; the fused qkv_w holds 1/tp of its columns on each
    rank, as JAX's test_mesh_params_are_sharded asks."""
    two, four = worlds["mesh2"], worlds["mesh4"]
    assert two["shapes"] == {"tp2": (1, 2), "dp2": (2, 1)}
    assert four["shapes"] == {"dp2 tp2": (2, 2), "tp4": (1, 4)}
    whole = two["ref_qkv_shape"]
    assert two["qkv_shape"] == {"tp2": whole[:-1] + (whole[-1] // 2,), "dp2": whole}
    assert four["qkv_shape"]["tp4"] == whole[:-1] + (whole[-1] // 4,)
    assert four["collectives"]["all_reduce"] > 0 and four["collectives"]["staged"] == 0


def test_server_on_mesh(worlds):
    """Rank 0 serves, rank 1 follows: /health answers, /inference gives the
    one-process transcript of the same WAV."""
    srv = worlds["mesh2"]["server"]
    assert srv["health"] == (200, {"status": "ok"})
    status, body = srv["inference"]
    assert status == 200
    assert body["text"].strip() == worlds["mesh2"]["ref_server_text"].strip() != ""


def _wav(path, seconds, seed):
    x = child.audio(seconds, seed)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def test_launcher_runs_end_to_end(ckpt, tmp_path):
    """tools/launch_multihost.py over two processes (a TCP init on the CPU:
    tp 2 by default) on the port's own checkpoint: both exit 0, rank 0
    prints the segments, the same lines a launch of one process prints."""
    wav = _wav(tmp_path / "a.wav", 8.0, 5)
    env = dict(os.environ, OMP_NUM_THREADS="2")

    def launch(n, port):
        return [subprocess.Popen(
            [sys.executable, "-m", "open_whisper_kit_tpu_torch.tools.launch_multihost",
             "--coordinator", f"127.0.0.1:{port}", "--num-hosts", str(n), "--host-id", str(r),
             "--model", str(ckpt), "--files", str(wav), "-ng"],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(n)]
    import socket
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    procs = launch(2, ports[0]) + launch(1, ports[1])
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e.decode()[-3000:]
    lines = [o.decode().splitlines() for o, _ in outs]
    assert lines[0] and all(ln.startswith("[") and "-->" in ln for ln in lines[0])
    assert lines[1] == []
    assert lines[0] == lines[2]
    assert "mesh dp 1 tp 2" in outs[0][1].decode()
