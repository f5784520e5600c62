"""The port's voice_command and wchess examples against the repo's
example scripts on the CPU: each `main -ng` prints what the script prints
on the same inputs (set-up and inputs: tests/_torch_examples.py).
"""

import pytest

from _torch_examples import files, no_fallback, outputs, write_wav  # noqa: F401
from open_whisper_kit_tpu_torch.examples import voice_command as TV
from open_whisper_kit_tpu_torch.examples import wchess as TW

import examples.voice_command as JV  # noqa: E402  (the repo's root is on sys.path)
import examples.wchess as JW  # noqa: E402


@pytest.mark.parametrize("mode", ["commands", "stream"])
def test_voice_command_matches_the_script(files, capsys, mode):
    """Grammar-constrained one-shot mode over a command list, and the
    VAD-gated streaming mode over a WAV with speech-like spans."""
    d = files["dir"]
    if mode == "commands":
        args = ["-m", str(files["grammar"]), "--commands", "up,down,left,right",
                "--input-wav", str(write_wav(d / "cmd.wav", 2.0, 1))]
    else:
        args = ["-m", str(files["whisper"]), "--input-wav",
                str(write_wav(d / "vad.wav", 4.0, 3, spans=[(0.5, 2.5)]))]
    j, t = outputs(capsys, JV.main, TV.main, args)
    assert t.out == j.out and "heard: " in t.out


def test_wchess_matches_the_script(files, capsys):
    """Text mode (board and legality alone) and a spoken move through the
    grammar of the legal moves."""
    text = ["--text", "d4; knight to f3; e5; e4; d2 to d4; queen to h5"]
    j, t = outputs(capsys, JW.main, TW.main, text)
    assert t.out == j.out and "illegal" in t.out and "d2-d4" in t.out
    d = files["dir"]
    audio = ["-m", str(files["grammar"]), "--audio", str(write_wav(d / "m1.wav", 2.0, 5))]
    j, t = outputs(capsys, JW.main, TW.main, audio)
    assert t.out == j.out and t.out.count("heard: ") == 1
