"""The port's talk and diarized_transcript examples against the repo's
example scripts on the CPU: each `main -ng` prints what the script prints
on the same inputs (set-up and inputs: tests/_torch_examples.py).
"""

from _torch_examples import files, no_fallback, outputs, write_wav  # noqa: F401
from open_whisper_kit_tpu_torch.examples import diarized_transcript as TD
from open_whisper_kit_tpu_torch.examples import talk as TT

import examples.diarized_transcript as JD  # noqa: E402  (the repo's root is on sys.path)
import examples.talk as JT  # noqa: E402


def test_talk_matches_the_script(files, capsys):
    """One voice-chat turn from a WAV: the transcript and the greedy reply
    (6 tokens) printed as the script prints them, with a written log."""
    d = files["dir"]
    prompt = d / "prompt.txt"
    prompt.write_text("{0} talks to {1}.\n{0}{4} hello\n{1}{4} hello\n{0}{4}")
    args = ["-mw", str(files["whisper"]), "-ml", str(files["llama"]),
            "--input-wav", str(write_wav(d / "q.wav", 3.0, 0)), "--temp", "0",
            "--reply-tokens", "6", "--max-turns", "1", "--prompt-file", str(prompt)]
    j, t = outputs(capsys, JT.main, TT.main, args + ["-f", str(d / "j.txt")],
                    ["-f", str(d / "t.txt")])
    assert t.out == j.out and t.out.count("LLaMA:") == 1 and len(t.out) > 20
    assert (d / "t.txt").read_text() == (d / "j.txt").read_text()


def test_talk_session_crosses_packages(files, capsys, tmp_path):
    """A session snapshot saved by either package resumes in the other
    (exact prompt match): the same reply as the saving package's next run."""
    d = files["dir"]
    prompt = d / "prompt.txt"
    prompt.write_text("{0} talks to {1}.\n{0}{4} hello\n{1}{4} hello\n{0}{4}")
    base = ["-mw", str(files["whisper"]), "-ml", str(files["llama"]),
            "--input-wav", str(write_wav(d / "q2.wav", 3.0, 0)), "--temp", "0",
            "--reply-tokens", "6", "--max-turns", "1", "--prompt-file", str(prompt)]
    outs = {}
    for saver, loader, tag in ((JT.main, lambda a: TT.main(a + ["-ng"]), "jax->port"),
                               (lambda a: TT.main(a + ["-ng"]), JT.main, "port->jax")):
        session = tmp_path / f"{tag}.npz"
        assert saver(base + ["--session", str(session)]) == 0
        first = capsys.readouterr()
        assert session.exists() and "restored" not in first.err
        assert loader(base + ["--session", str(session)]) == 0
        resumed = capsys.readouterr()
        assert "[session restored" in resumed.err, tag
        outs[tag] = (first.out, resumed.out)
        assert resumed.out == first.out, tag
    assert outs["jax->port"] == outs["port->jax"]


def test_diarized_transcript_matches_the_script(files, capsys, tmp_path):
    """Word timestamps, the TINY SortFormer's segments and the alignment:
    the same utterances printed and the same RTTM written."""
    wav = write_wav(tmp_path / "meeting.wav", 12.0, 2)
    args = [str(wav), "-m", str(files["whisper"]), "-dm", str(files["sortformer"]),
            "--preset", "low_latency"]
    j, t = outputs(capsys, JD.main, TD.main, args + ["--rttm-out", str(tmp_path / "j.rttm")],
                    ["--rttm-out", str(tmp_path / "t.rttm")])
    assert t.out == j.out and t.out.count("[speaker_") >= 1
    assert (tmp_path / "t.rttm").read_text() == (tmp_path / "j.rttm").read_text()
