#!/usr/bin/env python3
"""Multi-process bring-up for distributed transcription (port of the JAX
package's tools/launch_multihost.py).

One process per device: every process runs this same program, joins one
torch.distributed process group, builds the (dp, tp) mesh over all of them
(parallel/mesh.make_mesh) and a Transcriber on it, then transcribes each
file with full_parallel, its chunks shared out over dp (the
whisper_full_parallel chunk split, src/whisper.cpp:7801-7929). Every
process reads its own copy of the files and makes the same calls; rank 0
prints the segments.

Either give each process the group's address, size and rank (a TCP init):

    python -m open_whisper_kit_tpu_torch.tools.launch_multihost \\
        --coordinator 10.0.0.2:29500 --num-hosts 4 --host-id $RANK \\
        --model ggml-large-v3-turbo.bin --files a.wav b.wav

or let torchrun set them (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT):

    torchrun --nproc-per-node 4 -m open_whisper_kit_tpu_torch.tools.launch_multihost \\
        --model ggml-large-v3-turbo.bin --tp 2 --files a.wav

On the card the group is NCCL and each process takes the card of its
LOCAL_RANK; `-ng` runs every process on the CPU over Gloo.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="launch_multihost")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="processes in the group (one per device)")
    ap.add_argument("--host-id", type=int, default=None, help="this process's rank")
    ap.add_argument("--model", required=True)
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel width (default: 2 for an even process count)")
    ap.add_argument("--files", nargs="+", default=[])
    ap.add_argument("-ng", "--no-gpu", action="store_true",
                    help="run on the CPU, the group over Gloo")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..decode.full import _resolve_device

    device = _resolve_device("cpu" if args.no_gpu else "cuda").type   # raises without CUDA
    backend = "gloo" if args.no_gpu else "nccl"
    if args.coordinator:
        if args.num_hosts is None or args.host_id is None:
            ap.error("--coordinator needs --num-hosts and --host-id")
        dist.init_process_group(backend, init_method=f"tcp://{args.coordinator}",
                                world_size=args.num_hosts, rank=args.host_id)
    else:
        dist.init_process_group(backend)        # torchrun's environment

    from .. import api
    from ..audio.wav import load_wav
    from ..decode.params import FullParams
    from ..parallel import mesh as X

    try:
        mesh = X.make_mesh(tp=args.tp, device=device)
        rank = dist.get_rank()
        print(f"[rank {rank}] {dist.get_world_size()} processes, mesh dp "
              f"{X.axis_size(mesh, 'dp')} tp {X.axis_size(mesh, 'tp')} on "
              f"{X.mesh_device(mesh)}", file=sys.stderr)
        tr = api.Transcriber(model_path=args.model, dtype=torch.bfloat16,
                             device=X.mesh_device(mesh), mesh=mesh)
        params = FullParams(print_progress=False)
        for fname in args.files:
            res = tr.full_parallel(params, load_wav(fname),
                                   n_processors=X.axis_size(mesh, "dp"))
            if rank == 0:
                for s in res.segments:
                    print(f"[{s.t0 / 100:8.2f} --> {s.t1 / 100:8.2f}] {s.text}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
