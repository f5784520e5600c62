"""The repo's example programs on the PyTorch port: voice chat with an LLM
(`talk`), voice commands (`voice_command`), voice chess (`wchess`) and a
speaker-attributed transcript (`diarized_transcript`). Each runs as
``python -m open_whisper_kit_tpu_torch.examples.<name> ...`` with the
example script's flags, on the card (cuda:0; without CUDA it raises)
unless `-ng` asks for the CPU; `-dev N` picks cuda:N."""


def add_device_args(p) -> None:
    p.add_argument("-ng", "--no-gpu", action="store_true", help="run on the CPU")
    p.add_argument("-dev", "--gpu-device", type=int, default=0,
                   help="CUDA device index")


def device_of(args) -> str:
    """The torch device of -ng / -dev."""
    return "cpu" if args.no_gpu else f"cuda:{args.gpu_device}"
