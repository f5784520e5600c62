"""The port's whisper exporter (models/whisper/export.py) against the JAX
package's, and its round trip through the port's ggml writer and loader."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import NARROW_TS
from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.models.whisper import export as JE
from open_whisper_kit_tpu.models.whisper import model as JM
from open_whisper_kit_tpu_torch.io import ggml_whisper as TG
from open_whisper_kit_tpu_torch.io import ggml_writer as TW
from open_whisper_kit_tpu_torch.models.whisper import export as TE
from open_whisper_kit_tpu_torch.models.whisper import model as TM

torch.set_num_threads(2)


_F32 = {}


def _params(dtype):
    """The seed-3 f32 tree of the JAX package (drawn once), cast to `dtype`."""
    jcfg = JM.WhisperConfig(*NARROW_TS)
    if not _F32:
        _F32["tree"] = JM.init_params(jcfg, seed=3, dtype=jnp.float32, device=False)
    jp = jax.tree.map(lambda a: a.astype(dtype), _F32["tree"])
    return jcfg, jp, TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_tensors_from_params_equal_jax(dtype):
    """The same names, f32 arrays, shapes and layouts, bit for bit."""
    jcfg, jp, tp = _params(dtype)
    want = JE.tensors_from_params(jcfg, jp)
    got = TE.tensors_from_params(TM.WhisperConfig(*NARROW_TS), tp)
    assert list(got) == list(want)
    for name, a in want.items():
        assert got[name].dtype == np.float32 and got[name].shape == a.shape, name
        np.testing.assert_array_equal(got[name], a, err_msg=name)


def test_round_trip_through_the_writer(tmp_path):
    """export -> the port's ggml writer (f32) -> load_checkpoint ->
    params_from_checkpoint gives the tree back exactly."""
    _, _, tp = _params(jnp.float32)
    cfg = TM.WhisperConfig(*NARROW_TS)
    path = tmp_path / "rt.bin"
    tokens = [b"<%d>" % i for i in range(50257)]
    TW.write_checkpoint(path, TW.WhisperHParams(*NARROW_TS, ftype=0, qntvr=0),
                        JF._synthetic_mel_filters(80), tokens,
                        TE.tensors_from_params(cfg, tp), wtype=0)
    back = TM.params_from_checkpoint(TG.load_checkpoint(path), dtype=torch.float32)

    def walk(a, b, key=""):
        if isinstance(a, dict):
            assert set(a) == set(b), key
            for k in a:
                walk(a[k], b[k], f"{key}.{k}")
        else:
            assert a.shape == b.shape, key
            assert torch.equal(a, b), key
    walk(tp, back)
