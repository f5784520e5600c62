"""Silero VAD model in PyTorch, on an explicit device.

Port of open_whisper_kit_tpu/models/silero/vad.py, a re-derivation of the
reference's per-chunk ggml graph (whisper_vad_build_graph,
src/whisper.cpp:4519-4653) in two phases instead of one graph launch per
512-sample chunk:

1. `_features` -- STFT as a strided product (reflect pad 64, basis
   (258, 1, 256), hop 128, magnitude over 129 bins) and the 4-conv ReLU
   encoder, batched over ALL chunks at once,
2. `probs_scan` -- the sequential LSTM cell (gate order i, f, g, o) + final
   1x1 conv + sigmoid over the chunks with (h, c) carried, issued without
   host reads; the host reads the probabilities once at the end.

The convs are im2col products (`model.conv1d_mm`), not F.conv1d, and the
LSTM is the cell's own products, not nn.LSTM: matmuls stay f32 on the card
(torch's default), where cuDNN convolutions would run in TF32 under
torch's default `cudnn.allow_tf32`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...io.ggml_silero import SileroCheckpoint
from ..whisper.model import conv1d_mm

N_WINDOW = 512
_PAD = 64           # reflect pad on each side of the 512-window
_STFT_HOP = 128
_STFT_K = 256
_N_BINS = 129
_HIDDEN = 128


@dataclasses.dataclass
class SileroParams:
    stft_basis: torch.Tensor      # (256, 258): frame @ basis -> [real | imag]
    enc_w: list                   # 4 x (3, in, out)
    enc_b: list                   # 4 x (out,)
    w_ih: torch.Tensor            # (128, 512)
    b_ih: torch.Tensor            # (512,)
    w_hh: torch.Tensor            # (128, 512)
    b_hh: torch.Tensor            # (512,)
    final_w: torch.Tensor         # (128,)
    final_b: torch.Tensor         # ()


def params_from_checkpoint(ck: SileroCheckpoint, *,
                           device: str | torch.device) -> SileroParams:
    def f(name):
        return torch.from_numpy(np.ascontiguousarray(ck.to_float(name),
                                                     np.float32)).to(device)

    # stft basis stored (258, 1, 256) [out, in, k] -> (k, out)
    basis = f("_model.stft.forward_basis_buffer")[:, 0, :].t().contiguous()
    enc_w, enc_b = [], []
    for i in range(4):
        w = f(f"_model.encoder.{i}.reparam_conv.weight")   # (out, in, 3)
        enc_w.append(w.permute(2, 1, 0).contiguous())      # (3, in, out)
        enc_b.append(f(f"_model.encoder.{i}.reparam_conv.bias"))
    return SileroParams(
        stft_basis=basis, enc_w=enc_w, enc_b=enc_b,
        w_ih=f("_model.decoder.rnn.weight_ih").t().contiguous(),
        b_ih=f("_model.decoder.rnn.bias_ih"),
        w_hh=f("_model.decoder.rnn.weight_hh").t().contiguous(),
        b_hh=f("_model.decoder.rnn.bias_hh"),
        final_w=f("_model.decoder.decoder.2.weight").reshape(-1),
        final_b=f("_model.decoder.decoder.2.bias").reshape(()))


def init_state(batch: int = 1, *, device: str | torch.device):
    """(h, c) LSTM state, zeros (whisper_vad_reset_state)."""
    return (torch.zeros(batch, _HIDDEN, dtype=torch.float32, device=device),
            torch.zeros(batch, _HIDDEN, dtype=torch.float32, device=device))


def _features(p: SileroParams, windows: torch.Tensor) -> torch.Tensor:
    """(N, 512) windows -> (N, 128) per-chunk features, batched."""
    # reflect pad 64 each side (ggml_pad_reflect_1d, whisper.cpp:4523)
    x = F.pad(windows[:, None, :], (_PAD, _PAD), mode="reflect")[:, 0]   # (N, 640)
    frames = x.unfold(1, _STFT_K, _STFT_HOP)                  # (N, 4, 256)
    stft = torch.matmul(frames, p.stft_basis)                 # (N, 4, 258)
    real = stft[..., :_N_BINS]
    imag = stft[..., _N_BINS:]
    h = torch.sqrt(real * real + imag * imag)                 # (N, 4, 129)
    for w, b, s in zip(p.enc_w, p.enc_b, (1, 2, 2, 1)):
        h = torch.relu(conv1d_mm(h, w, s) + b)
    return h[:, 0, :]                                         # (N, 128)


def _lstm_cell(p: SileroParams, xw: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """PyTorch-gate-order LSTM cell (i, f, g, o; whisper.cpp:4574-4610);
    `xw` is the input's x @ w_ih + b_ih."""
    gates = xw + h @ p.w_hh + p.b_hh                          # (B, 512)
    i_t = torch.sigmoid(gates[:, 0:128])
    f_t = torch.sigmoid(gates[:, 128:256])
    g_t = torch.tanh(gates[:, 256:384])
    o_t = torch.sigmoid(gates[:, 384:512])
    c_new = f_t * c + i_t * g_t
    h_new = o_t * torch.tanh(c_new)
    return h_new, c_new


def probs_scan(p: SileroParams, windows: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor):
    """(N, 512) -> per-chunk speech probs (N,) on the windows' device;
    returns them with the final (h, c)."""
    xw = _features(p, windows) @ p.w_ih + p.b_ih               # (N, 512)
    probs = []
    for n in range(windows.shape[0]):
        h, c = _lstm_cell(p, xw[n:n + 1], h, c)
        probs.append(torch.sigmoid(torch.relu(h) @ p.final_w + p.final_b))
    return torch.cat(probs), h, c


class SileroVAD:
    """Stateful wrapper mirroring whisper_vad_context, on one device."""

    def __init__(self, params: SileroParams):
        self.params = params
        self.device = params.w_ih.device
        self.h, self.c = init_state(device=self.device)

    @classmethod
    def from_file(cls, path: str, *, device: str | torch.device) -> "SileroVAD":
        from ...io.ggml_silero import load_silero
        return cls(params_from_checkpoint(load_silero(path), device=device))

    def reset_state(self):
        self.h, self.c = init_state(device=self.device)

    def detect_speech(self, samples: np.ndarray, reset: bool = True) -> np.ndarray:
        """Per-512-sample-chunk speech probabilities
        (whisper_vad_detect_speech, src/whisper.cpp:5086-5185); one read of
        the device."""
        if reset:
            self.reset_state()
        samples = np.asarray(samples, np.float32)
        n = samples.shape[0]
        n_chunks = -(-n // N_WINDOW) if n else 0
        if n_chunks == 0:
            return np.zeros(0, np.float32)
        buf = np.zeros(n_chunks * N_WINDOW, np.float32)
        buf[:n] = samples
        windows = torch.from_numpy(buf.reshape(n_chunks, N_WINDOW)).to(self.device)
        probs, self.h, self.c = probs_scan(self.params, windows, self.h, self.c)
        return probs.cpu().numpy()
