"""Depth scan for the bf16 mesh encoder gate of chip_smoke.py's phase 36
(not collected by pytest; needs one CUDA card, no jax).

Dense large-v3-turbo weights (seed 0, bf16) and one 30 s window of seeded
audio; two ranks on the card over a Gloo group (tp 2, the collectives
staged through the host). At each depth of the encoder's first layers,
against one device (rank 0's), max|x - one| / max|one| and
mean|x - one| / mean|one| for:

* mesh: the encoder on the tp 2 mesh;
* control: the mesh with its f32 partial products rounded to bf16 before
  the all-reduce (a misplaced rounding the gate must catch);
* sound20, sound16, sound12: one device with its input scaled by
  1 + 2^-20, 2^-16, 2^-12.

Then chip_smoke's mesh_times: the mesh encoder pass and a one-row mesh
decode step beside one device's (wall ms, median of five).

    python3 tests/_torch_mesh_gate_scan.py

One JSON line (rank 0's readings) on stdout.
"""

import dataclasses
import json
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as CS  # noqa: E402

DEPTHS = (1, 2, 3, 4, 6, 8, 16)


def rank_main(rank: int, port: int, work: Path) -> None:
    import torch
    import torch.distributed as dist

    from open_whisper_kit_tpu_torch.audio import mel as mel_mod
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.decode import tokenizer as tok_mod
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    from open_whisper_kit_tpu_torch.ops import attention as A
    from open_whisper_kit_tpu_torch.parallel import mesh as X
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    mesh = X.make_mesh(tp=2, device="cuda")
    cfg = TM.WhisperConfig(*CS.TURBO)
    params = torch.load(work / "dense.pt", map_location="cuda")
    mel = mel_mod.log_mel_spectrogram(CS.audio(30.0, 30),
                                      TF._synthetic_mel_filters(cfg.n_mels), "cuda")
    res: dict = {}
    ctxs = CS.mesh_encoder(torch, TM, TF, A, X, tok_mod, cfg, params, mel, mesh, rank, res)
    window = mel.data[:2 * cfg.n_audio_ctx][None]
    res["depths"] = {}
    for depth in DEPTHS:
        cut = dataclasses.replace(cfg, n_audio_layer=depth)

        def enc(one, x):
            return TM.encode(cut, ctxs[one].params["encoder"], x).float()
        got = {"mesh": enc(False, window)}
        reduce = X.all_reduce_sum
        X.all_reduce_sum = lambda part, group: reduce(part.to(torch.bfloat16).float(), group)
        try:
            got["control"] = enc(False, window)
        finally:
            X.all_reduce_sum = reduce
        if rank == 0:
            one = enc(True, window)
            for e in (20, 16, 12):
                got[f"sound{e}"] = enc(True, window * (1 + 2.0 ** -e))
            res["depths"][depth] = {k: [CS._rel(v, one), CS._rel_mean(v, one)]
                                    for k, v in got.items()}
    (work / "idle").touch()
    res.update(CS.mesh_times(torch, TM, dist, cfg, ctxs, mel, mesh, rank, work))
    if rank == 0:
        res["card"] = CS.nvidia_smi_line()
        print(json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.models.whisper import model as TM
    cfg = TM.WhisperConfig(*CS.TURBO)
    with tempfile.TemporaryDirectory(prefix="mesh-gate-") as tmp:
        work = Path(tmp)
        ctx = TF.WhisperContext(cfg, TM.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                                    device="cuda"),
                                None, None, n_loaded=1, device="cuda")
        torch.save(CS.unfused_on_host(torch, ctx.params), work / "dense.pt")
        del ctx
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(port),
                                   str(work)]) for r in range(2)]
        rcs = [p.wait(timeout=900) for p in procs]
    return max(rcs)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
