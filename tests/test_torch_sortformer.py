"""The port's SortFormer model and streaming loops against the JAX package
(CPU, f32, the JAX tests' TINY config).

The same seeded numpy inputs go through each JAX function and its port:
the NeMo mel front-ends, the pre-encoder and the Conformer/Transformer head
(exact-length and bucket-padded), the GGUF writer and reader, the host AOSC
loop (numpy, the JAX package's code), the device AOSC loop (one read a
file), batched diarization and the true-streaming session. Unless a case
says otherwise values are held to 1e-5 of max|ref|.

Every input compared here keeps its JAX RTTM segments when it is scaled by
1 +- 2^-20, 2^-16 and 2^-13, its probabilities moving at most 1.2e-7 at
2^-20 and 3e-6 at 2^-13 (`python tests/sortformer_seed_scan.py`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.align import rttm as JR
from open_whisper_kit_tpu.audio import mel as JMEL
from open_whisper_kit_tpu.io.gguf import load_gguf as jload_gguf
from open_whisper_kit_tpu.models.sortformer import device_aosc as JD
from open_whisper_kit_tpu.models.sortformer import export as JE
from open_whisper_kit_tpu.models.sortformer import model as JM
from open_whisper_kit_tpu.models.sortformer import streaming as JS
from open_whisper_kit_tpu_torch.align import rttm as TR
from open_whisper_kit_tpu_torch.audio import mel as TMEL
from open_whisper_kit_tpu_torch.io.gguf import load_gguf
from open_whisper_kit_tpu_torch.models.sortformer import device_aosc as TD
from open_whisper_kit_tpu_torch.models.sortformer import export as TE
from open_whisper_kit_tpu_torch.models.sortformer import model as TM
from open_whisper_kit_tpu_torch.models.sortformer import streaming as TS

torch.set_num_threads(2)

TINY_ARGS = dict(n_mels=32, d_model=32, n_layers=2, n_heads=4, conv_kernel=5,
                 ff_expansion=2, subsampling_channels=8,
                 tf_layers=2, tf_d_model=16, tf_heads=4, tf_ff=32)
JTINY = JM.SortformerConfig(**TINY_ARGS)
TINY = TM.SortformerConfig(**TINY_ARGS)

# (stream config, audio seconds): the two presets over enough audio to pop
# the FIFO and compress the speaker cache, and the JAX tests' small configs
SMALL = {
    "small_fifo": dict(chunk_len=8, fifo_len=16, spkcache_len=16,
                       spkcache_update_period=12, chunk_left_context=1,
                       chunk_right_context=1, spkcache_sil_frames_per_spk=1),
    "small_rc3": dict(chunk_len=6, fifo_len=24, spkcache_len=20,
                      spkcache_update_period=16, chunk_right_context=3),
    "small_nofifo": dict(chunk_len=10),
}
CASES = {"offline": (dataclasses.asdict(JS.PRESETS["offline"]), 30.0),
         "low_latency": (dataclasses.asdict(JS.PRESETS["low_latency"]), 30.0),
         **{k: (v, 7.0) for k, v in SMALL.items()}}


def scfgs(name):
    kw, secs = CASES[name]
    return JS.StreamConfig(**kw), TS.StreamConfig(**kw), secs


def audio(seconds: float, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(int(16000 * seconds))
            .astype(np.float32) * 0.1)


def close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def segs(probs, mod):
    return [dataclasses.astuple(s) for s in mod.probs_to_segments(probs, 0.5, 11, "x")]


@pytest.fixture(scope="module")
def pair():
    """(JAX diarizer, port diarizer) over the same seed-0 TINY weights."""
    jp = JM.init_params(JTINY, seed=0)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return JS.SortformerDiarizer(JTINY, jp), TS.SortformerDiarizer(TINY, tp)


def test_init_params_equal_jax_weights(pair):
    """The port's init_params draws the JAX package's weights from the same
    seed, bit for bit, in the same layer-stacked layout."""
    own = TM.init_params(TINY, seed=0, device="cpu")
    ref = pair[1].params

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), f"{path}/{k}"
    walk(own, ref)
    assert ref["conformer"]["q_w"].shape == (2, 32, 32)
    assert ref["preenc"]["conv0_w"].shape == (3, 3, 1, 8)


@pytest.mark.parametrize("seconds", [3.0, 25.0])
def test_compute_mel_matches_jax(pair, seconds):
    """25 s is 2500 frames: it crosses the JAX side's 2048-frame chunk."""
    x = audio(seconds, 3)
    jm, jn = JM.compute_mel(JTINY, pair[0].params, x)
    tm, tn = TM.compute_mel(TINY, pair[1].params, x)
    assert tn == jn == int(16000 * seconds) // 160
    close(tm.numpy(), jm)
    assert tm.shape[0] % TINY.pad_to == 0 and not tm[tn:].any()


def test_nemo_log_mel_matches_jax():
    """The NeMo front-end's mel power (exp of the log-mel) within 1e-5 of
    JAX's max. In the log domain the low-energy bins of 128 mel filters
    amplify the f32 DFT products' rounding: there the port is held to a
    float64 rFFT reference and must be no further from it than JAX is
    (JAX 3.4e-4, the port 7.2e-5 at 4.3 s)."""
    from open_whisper_kit_tpu_torch.models.sortformer.mel_fb import mel_filterbank
    fb = mel_filterbank(128, 512, 16000)
    for seconds in (0.5, 4.3):
        x = audio(seconds, 4)
        ref = np.asarray(JMEL.nemo_log_mel(x, fb))
        got = TMEL.nemo_log_mel(x, fb, device="cpu").numpy()
        assert got.shape == ref.shape and got.shape[0] % 16 == 0
        # the log-guard padding rows are exact
        np.testing.assert_array_equal(got[-1], ref[-1])
        close(np.exp(got.astype(np.float64)), np.exp(ref.astype(np.float64)))
        y = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]]).astype(np.float64)
        p = np.concatenate([np.zeros(256), y, np.zeros(256)])
        n = 1 + (len(p) - 512) // 160
        win = np.zeros(512)
        win[56:456] = TMEL.hann_window(400, periodic=False)
        frames = np.stack([p[t * 160:t * 160 + 512] for t in range(n)]) * win
        spec = np.fft.rfft(frames, axis=-1)
        exact = np.log((spec.real ** 2 + spec.imag ** 2) @ fb.T.astype(np.float64) + 2.0 ** -24)
        assert np.abs(got[:n] - exact).max() <= np.abs(ref[:n] - exact).max()


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_preencode_matches_jax(pair, padded):
    rng = np.random.default_rng(10)
    T = 40
    mel = rng.standard_normal((2, T, TINY.n_mels)).astype(np.float32)
    exact = TM.preencode(TINY, pair[1].params, torch.from_numpy(mel)).numpy()
    if padded:
        mel = np.concatenate([mel, np.zeros((2, 64 - T, TINY.n_mels), np.float32)], axis=1)
    n = None if not padded else T
    ref = np.asarray(JM.preencode(JTINY, pair[0].params, jnp.asarray(mel),
                                  None if n is None else jnp.int32(n)))
    got = TM.preencode(TINY, pair[1].params, torch.from_numpy(mel), n).numpy()
    close(got, ref)
    k = TM.preenc_out_len(T)
    assert k == JM.preenc_out_len(T) == 5
    # bucket padding is masked: the live rows equal the exact-length call
    close(got[:, :k], exact[:, :k], 1e-6)


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_head_matches_jax(pair, padded):
    rng = np.random.default_rng(9)
    T = 13
    x = rng.standard_normal((2, T, TINY.d_model)).astype(np.float32)
    exact = TM.head(TINY, pair[1].params, torch.from_numpy(x)).numpy()
    if padded:
        x = np.concatenate([x, np.zeros((2, 32 - T, TINY.d_model), np.float32)], axis=1)
    n = None if not padded else T
    ref = np.asarray(JM.head(JTINY, pair[0].params, jnp.asarray(x),
                             None if n is None else jnp.int32(n)))
    got = TM.head(TINY, pair[1].params, torch.from_numpy(x), n).numpy()
    close(got, ref)
    assert got.shape == (2, x.shape[1], 4) and ((got >= 0) & (got <= 1)).all()
    close(got[:, :T], exact, 1e-6)
    if padded:
        # a (B,) tensor of lengths masks each row alone
        per_row = TM.head(TINY, pair[1].params, torch.from_numpy(x),
                          torch.tensor([T, 7])).numpy()
        close(per_row[0, :T], exact[0], 1e-6)
        seven = TM.head(TINY, pair[1].params, torch.from_numpy(x[1:, :7])).numpy()
        close(per_row[1, :7], seven[0], 1e-6)


def test_rel_shift_and_position_table():
    """After the Transformer-XL shift, bd[q, j] == raw[q, T-1 + j - q]; the
    rel-pos table equals JAX's, position 0 in its center row."""
    T = 5
    P = 2 * T - 1
    raw = (np.arange(P)[None, :] + 100 * np.arange(T)[:, None]).astype(np.float32)
    out = TM._rel_shift(torch.from_numpy(raw)[None, None])[0, 0].numpy()
    ref = np.asarray(JM._rel_shift(jnp.asarray(raw)[None, None]))[0, 0]
    np.testing.assert_array_equal(out, ref)
    for q in range(T):
        for j in range(T):
            assert out[q, j] == raw[q, T - 1 + j - q], (q, j)
    for T, d in ((4, 8), (64, 32), (448, 32), (448, 512)):
        pe = TM.sinusoid_pos_emb(T, d).numpy()
        ref = np.asarray(JM.sinusoid_pos_emb(T, d))
        assert pe.shape == (2 * T - 1, d)
        np.testing.assert_allclose(pe[T - 1, 0::2], 0.0, atol=1e-6)
        np.testing.assert_allclose(pe[T - 1, 1::2], 1.0, atol=1e-6)
        if d < 512:
            close(pe, ref)
        else:
            # published width: angles up to 447 rad with f32 frequencies put
            # both tables ~2.6e-5 from the exact one (1.5e-5 apart); the
            # port is no further from it than JAX, within an ulp of 1
            pos = (T - 1 - np.arange(2 * T - 1)).astype(np.float64)
            ang = pos[:, None] * 10000.0 ** (-(2.0 * np.arange(d // 2)) / d)[None]
            exact = np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(2 * T - 1, d)
            assert (np.abs(pe - exact).max()
                    <= np.abs(ref - exact).max() + np.finfo(np.float32).eps)


@pytest.mark.parametrize("half", [False, True], ids=["f32", "f16"])
def test_gguf_writers_byte_identical_and_load(pair, tmp_path, half):
    """The port's exporter writes the JAX exporter's bytes from the same
    weights; the port's reader gives the JAX reader's weights (bit for bit
    in f32) and config, and the same head output."""
    jpath = JE.write_sortformer_gguf(tmp_path / "j.gguf", JTINY, pair[0].params, half=half)
    tpath = TE.write_sortformer_gguf(tmp_path / "t.gguf", TINY, pair[1].params, half=half)
    assert tpath.read_bytes() == jpath.read_bytes()
    jcfg, jp = JM.params_from_gguf(jload_gguf(jpath))
    tcfg, tp = TM.params_from_gguf(load_gguf(tpath), device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == TINY
    ref = TM.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for path, leaf in _leaves(tp):
        assert torch.equal(leaf, _get(ref, path)), path
    if not half:
        for path, leaf in _leaves(tp):
            assert torch.equal(leaf, _get(pair[1].params, path)), path
    x = np.random.default_rng(0).standard_normal((1, 12, 32)).astype(np.float32)
    close(TM.head(tcfg, tp, torch.from_numpy(x)).numpy(),
          np.asarray(JM.head(jcfg, jp, jnp.asarray(x))))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_fused_chunk_matches_two_call_path(pair):
    """_fused_chunk (one device call, one read) == _preencode + host concat
    + _chunk_predict on the live rows, and equals JAX's."""
    dz = pair[1]
    rng = np.random.default_rng(11)
    chunk_mel = rng.standard_normal((100, TINY.n_mels)).astype(np.float32)
    prefix = rng.standard_normal((37, TINY.d_model)).astype(np.float32) * 0.1
    pre_ref = dz._preencode(torch.from_numpy(chunk_mel))
    preds_ref = dz._chunk_predict(np.concatenate([prefix, pre_ref]))
    n0 = dz.reads.n
    pre, preds = dz._fused_chunk(torch.from_numpy(chunk_mel), prefix)
    assert dz.reads.n == n0 + 1
    close(pre, pre_ref, 1e-6)
    close(preds, preds_ref, 1e-6)
    jpre, jpreds = pair[0]._fused_chunk(chunk_mel, prefix)
    close(pre, jpre)
    close(preds, jpreds)


@pytest.mark.parametrize("name", list(CASES))
def test_host_loop_matches_jax(pair, name):
    """The host AOSC loop (numpy) over the port's chunk compute against
    JAX's host loop: the same probabilities and RTTM segments."""
    jcfg, tcfg, secs = scfgs(name)
    x = audio(secs, 0)
    ref = pair[0].diarize(x, jcfg)
    n0 = pair[1].reads.n
    got = pair[1].diarize(x, tcfg)
    close(got, ref)
    assert segs(got, TR) == segs(ref, JR) and len(segs(got, TR)) > 0
    # one read a chunk: the packed pre-encoder output and predictions
    assert pair[1].reads.n - n0 == len(TD._chunk_schedule(TINY, tcfg, int(16000 * secs) // 160)[0])


@pytest.mark.parametrize("name", list(CASES))
def test_device_loop_matches_host_and_jax(pair, name):
    """The device AOSC loop: within 1e-6 of the port's host loop, within
    1e-5 of JAX's device loop, one host read for the whole file."""
    jcfg, tcfg, secs = scfgs(name)
    x = audio(secs, 2)
    host = pair[1].diarize(x, tcfg)
    n0 = pair[1].reads.n
    got = pair[1].diarize(x, tcfg, device_state=True)
    assert pair[1].reads.n - n0 == 1
    assert got.shape == host.shape
    assert np.abs(got - host).max() <= 1e-6
    close(got, pair[0].diarize(x, jcfg, device_state=True))
    assert segs(got, TR) == segs(host, TR)


def test_compress_device_matches_host_and_jax():
    """compress_spkcache on random states: the device form (stable sort)
    equals the numpy form, and on tie-heavy predictions (exact 0 / 1,
    clipped scores) equals JAX's device form (lax.top_k's order)."""
    scfg = TS.StreamConfig(spkcache_len=16, spkcache_sil_frames_per_spk=1)
    jkey = JD._scfg_key(JS.StreamConfig(spkcache_len=16, spkcache_sil_frames_per_spk=1))
    rng = np.random.default_rng(0)
    for n, ties in ((40, False), (30, False), (40, True), (25, True)):
        sc = rng.standard_normal((n, 8)).astype(np.float32)
        preds = rng.random((n, 4)).astype(np.float32)
        if ties:
            preds = np.where(preds > 0.5, 1.0, np.where(preds < 0.2, 0.0, 0.6)).astype(np.float32)
        sil = rng.standard_normal(8).astype(np.float32)
        SC_MAX = 48
        buf = np.zeros((SC_MAX, 8), np.float32)
        buf[:n] = sc
        pbuf = np.zeros((SC_MAX, 4), np.float32)
        pbuf[:n] = preds
        dsc, dp, dn = TD._compress_dev(torch.from_numpy(buf)[None], torch.from_numpy(pbuf)[None],
                                       torch.tensor([n]), torch.from_numpy(sil)[None], scfg)
        assert int(dn[0]) == 16
        jsc, jp, _ = JD._compress_dev(jnp.asarray(buf), jnp.asarray(pbuf), jnp.int32(n),
                                      jnp.asarray(sil), jkey)
        np.testing.assert_array_equal(dsc[0].numpy(), np.asarray(jsc))
        np.testing.assert_array_equal(dp[0].numpy(), np.asarray(jp))
        if not ties:
            st = TS.StreamState(8)
            st.spkcache, st.spkcache_preds, st.spkcache_preds_valid = sc, preds, True
            st.mean_sil_emb = sil
            TS.compress_spkcache(st, scfg)
            np.testing.assert_array_equal(dsc[0, :16].numpy(), st.spkcache)
            np.testing.assert_array_equal(dp[0, :16].numpy(), st.spkcache_preds)


def test_diarize_batch_matches_single_and_jax(pair):
    """Lockstep batches with uneven lengths: the longest file equals its
    single call (1e-6), the shorter ones ride on zero-padded mel (JAX's own
    bound: max 0.1, mean 0.02); both loops equal JAX's batch."""
    jcfg, tcfg, _ = scfgs("small_fifo")
    xs = [audio(5.0, 20), audio(3.0, 21), audio(5.0, 22)]
    host = pair[1].diarize_batch(xs, tcfg)
    n0 = pair[1].reads.n
    dev = pair[1].diarize_batch(xs, tcfg, device_state=True)
    assert pair[1].reads.n - n0 == 1
    jhost = pair[0].diarize_batch(xs, jcfg)
    jdev = pair[0].diarize_batch(xs, jcfg, device_state=True)
    for i, x in enumerate(xs):
        close(host[i], jhost[i])
        close(dev[i], jdev[i])
        assert np.abs(dev[i] - host[i]).max() <= 1e-6
        single = pair[1].diarize(x, tcfg)
        assert host[i].shape == single.shape
        if i != 1:
            assert np.abs(host[i] - single).max() <= 1e-6
        else:
            assert np.abs(host[i] - single).max() <= 0.1
            assert np.abs(host[i] - single).mean() < 0.02
    assert pair[1].diarize_batch([], tcfg) == [] and pair[1].diarize_batch([], tcfg, True) == []


@pytest.mark.parametrize("name,seconds", [("small_fifo", 6.0), ("low_latency", 16.0)])
def test_stream_device_state_matches_host_and_jax(pair, name, seconds):
    """True streaming fed in uneven pieces: the device-state session within
    1e-5 of the host-state one, both within 1e-5 of JAX's streams; the
    device session reads once a chunk. The small config streams with 2
    chunks of right context (the JAX test's)."""
    kw = dict(CASES[name][0], **({"chunk_right_context": 2} if name == "small_fifo" else {}))
    jcfg, tcfg = JS.StreamConfig(**kw), TS.StreamConfig(**kw)
    x = audio(seconds, 9)

    def run(mod, d, cfg, device_state):
        s = mod.SortformerStream(d, cfg, device_state=device_state)
        for i in range(0, len(x), 5000):
            s.feed(x[i:i + 5000])
        s.finish()
        return s

    host = run(TS, pair[1], tcfg, False)
    n0 = pair[1].reads.n
    dev = run(TS, pair[1], tcfg, True)
    assert pair[1].reads.n - n0 == dev.n_chunks == host.n_chunks > 1
    got, ref = dev.probs(), host.probs()
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-5
    close(ref, run(JS, pair[0], jcfg, False).probs())
    close(got, run(JS, pair[0], jcfg, True).probs())
