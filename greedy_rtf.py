#!/usr/bin/env python3
"""Time greedy large-v3-turbo requests of the PyTorch port on one GPU, for
one or more source trees in turn.

    python3 greedy_rtf.py ROOT [ROOT ...] [--reps 3] [--model dense|q8_0]
                          [--request auto|no-megakernel|cross-kv-int8|speculative|
                                     beam5|batch-k8-int8|batch-k8-dense ...]

Each ROOT is a directory holding `open_whisper_kit_tpu_torch/`: this
checkout, or another commit unpacked with `git archive` into a git-ignored
directory such as `build/`. Each root runs in a process of its own, in the
order given, so naming roots as A B B A interleaves two trees on one card.
A process builds the dense bf16 large-v3-turbo preset from seed 0 on cuda
(`--model dense`, the default) or loads a full-width large-v3-turbo q8_0
checkpoint of seed-0 random tensors in bf16 (`--model q8_0`; written once,
by this checkout's writer, into a temporary directory under `build/`, and
removed at the end; its token steps run K2 by themselves), serves one
warm-up request, then `--reps` timed requests of 30 s of
seeded noise with `temperature_inc = 0` (the greedy device loop alone),
for each `--request` kind in turn: `auto` (the defaults), `no-megakernel`
(megakernel=False: every token step runs decode_impl, 16 quantized linears
through K3's rows route on the q8_0 model) or `cross-kv-int8`
(cross_kv_int8=True, which also keeps K2 off) or `speculative` (q8_0
only: speculative greedy with gamma 4 and a q4_0 draft of the same seed-0
tensors, written beside the target, as chip_smoke.py's phase 16 draft (a);
its token steps run K2 at one row and its verify passes K2 at five) or
`beam5` (q8_0 only: beam search with beam_size 5, the rest as `auto`:
every beam token step one K7 launch, int8 planes) or
`batch-k8-int8` / `batch-k8-dense` (dense model only: transcribe_batch of
eight 30 s files, audio seeds 500-507, with the W8A8 encoder and
megakernel="int8" / True, chip_smoke.py's phase-14 request: every
lockstep step one K8 launch, int8 or dense planes). Each timed request
prints one JSON line: the root, the model, the request kind, wall seconds
(host clock, ending in `torch.cuda.synchronize()`), RTF, sampled tokens,
encoder passes and wall ms per sampled token (beam5 also K7's launches;
a batched request: wall
seconds, audio seconds per second, K8 launches and emitted tokens, then
`--reps` timed encoder + cross-KV rounds of its eight first windows on the
W8A8 encoder, kernel K6's path: the device span and the host's time to
issue it). Then `--reps` timed passes of the request's first window
through the (dense or q8_0) encoder and cross-KV print the window's device
span (CUDA events) and the host's time to issue it. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SECONDS, AUDIO_SEED = 30.0, 30
REPO = Path(__file__).resolve().parent
TURBO = (51866, 1500, 1280, 20, 32, 448, 1280, 20, 4, 128)   # large-v3-turbo hparams


def write_checkpoints(paths: dict) -> None:
    """Large-v3-turbo checkpoints of the same seed-0 random tensors, written
    by this checkout's port (as chip_smoke.py's phase 6 writes them):
    {"q8_0": path, "q4_0": path, ...}."""
    sys.path.insert(0, str(REPO))
    from open_whisper_kit_tpu_torch.decode import full as TF
    from open_whisper_kit_tpu_torch.io import ggml_writer as W
    hp = W.WhisperHParams(*TURBO, ftype=1, qntvr=0)
    tokens = [b"<%d>" % i for i in range(50257)]
    tensors = W.random_reference_tensors(hp, seed=0)
    for wtype, path in paths.items():
        W.write_checkpoint(path, hp, TF._synthetic_mel_filters(128), tokens, tensors,
                           wtype=W.TYPE_FOR_NAME[wtype])


REQUESTS = {"auto": {}, "no-megakernel": {"megakernel": False},
            "cross-kv-int8": {"cross_kv_int8": True}, "speculative": {"speculative": 4},
            "beam5": {"beam_size": 5},
            "batch-k8-int8": {"megakernel": "int8"}, "batch-k8-dense": {"megakernel": True}}
BATCH_FILES = 8           # 30 s files of a batched request, audio seeds 500 + b


def child(root: Path, reps: int, model_path: Path | None, requests: list[str],
          draft_path: Path | None) -> None:
    sys.path.insert(0, str(root))
    import dataclasses

    import numpy as np
    import torch
    from open_whisper_kit_tpu_torch import Transcriber
    from open_whisper_kit_tpu_torch.decode.params import (BeamSearchParams, FullParams,
                                                          SamplingStrategy)
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK

    if not torch.cuda.is_available():
        sys.exit("greedy_rtf: no CUDA device")
    samples = (np.random.default_rng(AUDIO_SEED).standard_normal(int(16000 * SECONDS))
               .astype(np.float32) * 0.1)
    if model_path is None:
        tr = Transcriber(preset="large-v3-turbo", dtype=torch.bfloat16, device="cuda",
                         seed=0)
    else:
        tr = Transcriber(model_path=model_path, dtype=torch.bfloat16, device="cuda")
    if draft_path is not None:   # read only by the speculative requests
        from open_whisper_kit_tpu_torch.decode import full as TF
        tr.ctx.set_draft(TF.WhisperContext.from_file(draft_path, dtype=torch.bfloat16,
                                                     device="cuda"))
    for request in requests:
        if request.startswith("batch"):
            batch_request(root, tr, request, reps)
            continue
        for rep in range(reps + 1):
            p = FullParams(print_progress=False)
            p.temperature_inc = 0
            for field, value in REQUESTS[request].items():
                if field == "beam_size":
                    p = dataclasses.replace(p, strategy=SamplingStrategy.BEAM_SEARCH,
                                            beam_search=BeamSearchParams(beam_size=value))
                else:
                    setattr(p, field, value)
            k7 = MK.mega_decode_step_beam.launches
            t0 = time.perf_counter()
            res = tr.transcribe(samples, p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rep == 0:
                continue   # warm-up: first launches, allocator growth
            n = res.timings.n_sample
            print(json.dumps({"root": str(root), "model": "dense" if model_path is None
                              else "q8_0", "request": request, "rep": rep, "wall_s": wall,
                              "rtf": wall / SECONDS, "sampled_tokens": n,
                              "encoder_passes": res.timings.n_encode,
                              "spec_accepted": res.timings.n_spec_accepted,
                              "k7_launches": MK.mega_decode_step_beam.launches - k7,
                              "ms_per_token": 1e3 * wall / max(n, 1)}), flush=True)
    # the request's first window alone: encoder + cross-KV, the device span
    # (CUDA events) beside the host's time to issue it; where the two are
    # equal the host paces the window
    from open_whisper_kit_tpu_torch.audio import mel as mel_mod
    mel = mel_mod.log_mel_spectrogram(samples, tr.ctx.filters, "cuda")
    for rep in range(reps + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        tr.ctx.encode_window(mel.data, 0, 0)
        issue = time.perf_counter() - t0
        b.record()
        b.synchronize()
        if rep:
            print(json.dumps({"root": str(root), "model": "dense" if model_path is None
                              else "q8_0", "rep": rep, "encoder_window_ms": a.elapsed_time(b),
                              "encoder_issue_ms": 1e3 * issue}), flush=True)


def batch_request(root: Path, tr, request: str, reps: int) -> None:
    """transcribe_batch of BATCH_FILES x 30 s with the W8A8 encoder swapped
    in (restored after): one warm-up, then `reps` timed requests."""
    import numpy as np
    import torch
    from open_whisper_kit_tpu_torch.decode.params import FullParams
    from open_whisper_kit_tpu_torch.ops import decode_megakernel as MK
    from open_whisper_kit_tpu_torch.ops import encoder_int8 as E8
    files = [(np.random.default_rng(500 + b).standard_normal(int(16000 * SECONDS))
              .astype(np.float32) * 0.1) for b in range(BATCH_FILES)]
    dense_enc = tr.ctx.params["encoder"]
    tr.ctx.params["encoder"] = E8.prepare_encoder_int8(tr.ctx.cfg, dense_enc)
    try:
        for rep in range(reps + 1):
            p = FullParams(print_progress=False)
            p.temperature_inc = 0
            for field, value in REQUESTS[request].items():
                setattr(p, field, value)
            k8 = MK.mega_decode_step_batch.launches
            t0 = time.perf_counter()
            results = tr.transcribe_batch(files, p)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if rep == 0:
                continue
            print(json.dumps({"root": str(root), "model": "dense", "request": request,
                              "rep": rep, "wall_s": wall,
                              "audio_s_per_s": BATCH_FILES * SECONDS / wall,
                              "k8_launches": MK.mega_decode_step_batch.launches - k8,
                              "emitted_tokens": sum(len(s.tokens) for r in results
                                                    for s in r.segments)}), flush=True)
        # one round's encoder + cross-KV on the W8A8 encoder (the files'
        # first windows): the device span beside the host's time to issue it
        from open_whisper_kit_tpu_torch.audio import mel as mel_mod
        from open_whisper_kit_tpu_torch.models.whisper import model as TM
        mel = mel_mod.log_mel_spectrogram(np.concatenate(files), tr.ctx.filters, "cuda")
        windows = torch.stack([mel.data[b * 3000:(b + 1) * 3000] for b in range(BATCH_FILES)])
        for rep in range(reps + 1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.record()
            TM.encode_with_cross_kv(tr.ctx.cfg, tr.ctx.params["encoder"],
                                    tr.ctx.params["decoder"], windows)
            issue = time.perf_counter() - t0
            b.record()
            b.synchronize()
            if rep:
                print(json.dumps({"root": str(root), "model": "dense", "request": request,
                                  "rep": rep, "encoder_round_ms": a.elapsed_time(b),
                                  "encoder_round_issue_ms": 1e3 * issue}), flush=True)
    finally:
        tr.ctx.params["encoder"] = dense_enc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model", choices=("dense", "q8_0"), default="dense")
    ap.add_argument("--request", choices=tuple(REQUESTS), action="append",
                    help="request kind, repeatable (default: auto)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--model-path", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--draft-path", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    requests = args.request or ["auto"]
    if args.child:
        child(args.roots[0].resolve(), args.reps, args.model_path, requests, args.draft_path)
        return 0
    for kind in ("speculative", "beam5"):
        if kind in requests and args.model != "q8_0":
            ap.error(f"--request {kind} needs --model q8_0")
    if any(r.startswith("batch") for r in requests) and args.model != "dense":
        ap.error("--request batch-k8-* needs --model dense")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    tmp = None
    extra = []
    try:
        if args.model == "q8_0":
            (REPO / "build").mkdir(exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="greedy-rtf-", dir=REPO / "build"))
            paths = {"q8_0": tmp / "ggml-large-v3-turbo-q8_0.bin"}
            if "speculative" in requests:
                paths["q4_0"] = tmp / "draft-q4_0-seed0.bin"
            write_checkpoints(paths)
            extra = ["--model-path", str(paths["q8_0"])]
            if "q4_0" in paths:
                extra += ["--draft-path", str(paths["q4_0"])]
        for root in args.roots:
            kinds = [f"--request={r}" for r in requests]
            subprocess.run([sys.executable, __file__, "--child", "--reps", str(args.reps),
                            *kinds, *extra, str(root)], check=True, timeout=900)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
