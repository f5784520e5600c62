"""Shared set-up for the PyTorch-port parity tests: one weight tree, fed to
a JAX WhisperContext and to the port's WhisperContext (CPU, f32)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from open_whisper_kit_tpu.decode import full as JF
from open_whisper_kit_tpu.decode import tokenizer as JTOK
from open_whisper_kit_tpu.models.whisper import model as M
from open_whisper_kit_tpu_torch.decode import full as TF
from open_whisper_kit_tpu_torch.decode import tokenizer as TTOK
from open_whisper_kit_tpu_torch.models.whisper import model as TM

# tiny.en's vocabulary and context lengths, two 64-wide heads (S % 128 == 0)
NARROW = (51864, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
# the same with three decoder layers: a 2-layer decoder with tiny.en's
# vocabulary forces no_timestamps (the distilled-model rule), three keep
# the timestamp machinery in play
NARROW_TS = (51864, 1500, 128, 2, 2, 448, 128, 2, 3, 80)


def contexts(args, seed: int = 0, **kw):
    """(jax_ctx, port_ctx) over the same seed-`seed` f32 weights; `kw`
    (encoder_int8) goes to both contexts."""
    jcfg = M.WhisperConfig(*args)
    params = M.init_params(jcfg, seed=seed, dtype=jnp.float32, device=False)
    tokens = [b"<%d>" % i for i in range(min(jcfg.n_vocab, 50257))]
    filters = JF._synthetic_mel_filters(jcfg.n_mels)
    jctx = JF.WhisperContext(jcfg, params, JTOK.build_vocab(tokens, jcfg.n_vocab),
                             filters, n_loaded=1, dtype=jnp.float32, **kw)
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    tctx = TF.WhisperContext(TM.WhisperConfig(*args), tparams,
                             TTOK.build_vocab(tokens, jcfg.n_vocab), filters,
                             n_loaded=1, dtype=torch.float32, device="cpu", **kw)
    return jctx, tctx


def audio(seconds: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def segments(res):
    return [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in res.segments]


def write_checkpoint(path, args=NARROW_TS, seed: int = 0, words=(), named=None):
    """An f32 ggml-bin of the seed-`seed` weights `contexts(args, seed)`
    builds (the JAX package's init_params, written by the port's writer),
    with the same token strings and filters: both packages load it into
    the contexts' weights, for the entry points that take a file. `words`
    (byte strings) replace the token strings from id 1000 on, for the
    entry points that tokenize text. With `named`, the token strings from
    id `named` to the end-of-text id are empty and their embedding rows
    zero: a grammar's token automaton walks only the tokens with text
    (empty ones are never its candidates), and a zero row's logit 0 stays
    below the best of the named tokens', so the model does not pick them."""
    from open_whisper_kit_tpu.models.whisper.export import tensors_from_params
    from open_whisper_kit_tpu_torch.io import ggml_writer as TW
    jcfg = M.WhisperConfig(*args)
    params = M.init_params(jcfg, seed=seed, dtype=jnp.float32, device=False)
    tokens = [b"<%d>" % i for i in range(min(jcfg.n_vocab, 50257))]
    tokens[1000:1000 + len(words)] = list(words)
    tensors = tensors_from_params(jcfg, jax.tree.map(np.asarray, params))
    if named is not None:
        tokens[named:50256] = [b""] * (50256 - named)
        te = tensors["decoder.token_embedding.weight"].copy()
        te[named:50256] = 0.0
        tensors["decoder.token_embedding.weight"] = te
    TW.write_checkpoint(path, TW.WhisperHParams(*args, ftype=0, qntvr=0),
                        JF._synthetic_mel_filters(jcfg.n_mels), tokens, tensors, wtype=0)
    return path
