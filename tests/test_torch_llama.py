"""The port's LLaMA runtime (models/llama) against the JAX package's on the
CPU: GGUF loads, forward logits, greedy generation, the sampler's filter.

The narrow model is tests/test_llama.py's TINY (2 layers, width 64, 4
query / 2 kv heads, a 320-piece SPM vocab), written with the port's
GGUFWriter. Greedy parity uses the seed-0 weights: every compared request
keeps its JAX tokens when the prompt embedding is scaled by 1 + 2^-20
(checked by `test_greedy_requests_are_not_near_ties`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_whisper_kit_tpu.io.gguf import load_gguf as jload_gguf
from open_whisper_kit_tpu.models.llama import model as LM
from open_whisper_kit_tpu_torch.io import quant as Q
from open_whisper_kit_tpu_torch.io.ggml_writer import _encode_tensor
from open_whisper_kit_tpu_torch.io.gguf import GGUFWriter, load_gguf
from open_whisper_kit_tpu_torch.models.llama import model as TL
from open_whisper_kit_tpu_torch.models.llama.tokenizer import ATTR_NORMAL
from test_llama import _spm_vocab_lists

torch.set_num_threads(2)

TINY = dict(vocab=320, embd=64, layers=2, heads=4, heads_kv=2, ff=128, ctx=128)
_EXACT = {"xla_allow_excess_precision": False}   # see test_torch_megakernel.py


def _vocab_lists(n):
    """tests/test_llama.py's SPM vocabulary padded to `n` pieces."""
    tokens, scores, ttype = _spm_vocab_lists()
    pad = n - len(tokens)
    return (tokens + [f"<extra{i}>" for i in range(pad)],
            np.asarray(scores + [0.0] * pad, np.float32),
            np.asarray(ttype + [ATTR_NORMAL] * pad, np.int32))


def write_gguf(path, seed=0, tie=False, layers=TINY["layers"], types=None, rope=None):
    """A random-weight TINY llama GGUF in llama.cpp's layout (llama-arch.cpp
    tensor names, llama.* metadata keys); `types` maps a tensor name to a
    ggml type to store it quantized; `rope` adds llama.rope.* keys (a str
    value as a string, a number as f32)."""
    t = TINY
    S, F, V = t["embd"], t["ff"], t["vocab"]
    kvd = t["heads_kv"] * (S // t["heads"])
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    w.add_string("general.architecture", "llama")
    w.add_uint32("llama.embedding_length", S)
    w.add_uint32("llama.block_count", layers)
    w.add_uint32("llama.attention.head_count", t["heads"])
    w.add_uint32("llama.attention.head_count_kv", t["heads_kv"])
    w.add_uint32("llama.feed_forward_length", F)
    w.add_uint32("llama.context_length", t["ctx"])
    w.add_uint32("llama.vocab_size", V)
    w.add_float32("llama.rope.freq_base", 10000.0)
    w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
    for key, value in (rope or {}).items():
        (w.add_string if isinstance(value, str) else w.add_float32)(f"llama.rope.{key}", value)
    tokens, scores, ttype = _vocab_lists(V)
    w.add_string("tokenizer.ggml.model", "llama")
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.scores", scores)
    w.add_array("tokenizer.ggml.token_type", ttype)
    w.add_uint32("tokenizer.ggml.bos_token_id", 1)
    w.add_uint32("tokenizer.ggml.eos_token_id", 2)
    w.add_uint32("tokenizer.ggml.unknown_token_id", 0)
    w.add_bool("tokenizer.ggml.add_bos_token", True)

    def r(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)

    plan = {"token_embd.weight": r(V, S), "output_norm.weight": np.abs(r(S)) + 0.5}
    if not tie:
        plan["output.weight"] = r(V, S)
    for i in range(layers):
        p = f"blk.{i}."
        plan.update({p + "attn_norm.weight": np.abs(r(S)) + 0.5,
                     p + "attn_q.weight": r(S, S), p + "attn_k.weight": r(kvd, S),
                     p + "attn_v.weight": r(kvd, S), p + "attn_output.weight": r(S, S),
                     p + "ffn_norm.weight": np.abs(r(S)) + 0.5,
                     p + "ffn_gate.weight": r(F, S), p + "ffn_up.weight": r(F, S),
                     p + "ffn_down.weight": r(S, F)})
    for name, data in plan.items():
        ttyp = (types or {}).get(name)
        if ttyp is None:
            w.add_tensor(name, data)
        else:
            w.add_tensor_raw(name, _encode_tensor(data, ttyp), data.shape, ttyp)
    w.write()
    return path


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("llama")
    return {"plain": write_gguf(d / "tiny.gguf"),
            "tied": write_gguf(d / "tied.gguf", seed=1, tie=True)}


def _both(path, dtype=jnp.float32, tdtype=torch.float32):
    jcfg, jp = LM.params_from_gguf(jload_gguf(path), dtype=dtype)
    tcfg, tp = TL.params_from_gguf(load_gguf(path), dtype=tdtype, device="cpu")
    return jcfg, jp, tcfg, tp


def _assert_same_tree(jp, tp):
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf.astype(jnp.float32))
        np.testing.assert_array_equal(t.float().numpy(), want, err_msg=str(path))
        assert t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            str(leaf.dtype)], str(path)
        n += 1
    assert n == 12     # tok_emb, output_norm, output and 9 block stacks


@pytest.mark.parametrize("kind,dtype", [("plain", "f32"), ("tied", "f32"),
                                        ("plain", "bf16"), ("tied", "bf16")])
def test_gguf_loads_equal_jax(ggufs, kind, dtype):
    """Plain and tied-embedding files load to JAX's parameters exactly:
    the un-permuted q/k rows, the (in, out) layout, f32 norms, the cast."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg, jp, tcfg, tp = _both(ggufs[kind], jd, td)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    _assert_same_tree(jp, tp)
    if kind == "tied":
        torch.testing.assert_close(tp["output"], tp["tok_emb"].t(), rtol=0, atol=0)


def test_quantized_gguf_loads_equal_jax(tmp_path):
    """A llama.cpp Q4_K_M-style mix of q4_0 / q8_0 / q4_K / q6_K tensors
    dequantizes to JAX's parameters bit for bit."""
    mix = {"token_embd.weight": Q.GGML_TYPE_Q8_0, "output.weight": Q.GGML_TYPE_Q6_K,
           "blk.0.attn_q.weight": Q.GGML_TYPE_Q4_0, "blk.0.attn_k.weight": Q.GGML_TYPE_Q4_K,
           "blk.0.attn_v.weight": Q.GGML_TYPE_Q8_0, "blk.0.attn_output.weight": Q.GGML_TYPE_Q4_0,
           "blk.0.ffn_gate.weight": Q.GGML_TYPE_Q4_K, "blk.0.ffn_up.weight": Q.GGML_TYPE_Q8_0,
           "blk.0.ffn_down.weight": Q.GGML_TYPE_Q6_K}
    path = write_gguf(tmp_path / "q.gguf", seed=7, layers=1, types=mix)
    gf = load_gguf(path)
    assert {n: gf.tensors[n].ggml_type for n in mix} == mix
    jcfg, jp, tcfg, tp = _both(path)
    assert tcfg.n_layer == 1
    _assert_same_tree(jp, tp)


def _forward_both(jcfg, jp, tcfg, tp, steps, n_cache=48, compile_exact=False):
    """Feed each token list of `steps` in turn (ingest, then more ingest or
    single steps) through both forwards; yields (jax logits, port logits)
    and finally the caches."""
    jdt = jp["tok_emb"].dtype
    kk, kv = LM.init_kv_cache(jcfg, 1, n_cache, jdt)
    tk, tv = TL.init_kv_cache(tcfg, 1, n_cache, tp["tok_emb"].dtype, device="cpu")
    pos, out = 0, []
    for toks in steps:
        args = (jp, jnp.asarray([toks], jnp.int32), kk, kv, jnp.asarray(pos, jnp.int32))
        if compile_exact:
            fn = LM.forward.lower(jcfg, *args).compile(compiler_options=_EXACT)
            jl, kk, kv = fn(*args)
        else:
            jl, kk, kv = LM.forward(jcfg, *args)
        tl, tk, tv = TL.forward(tcfg, tp, torch.tensor([toks]), tk, tv, pos)
        out.append((np.asarray(jl.astype(jnp.float32)), tl.numpy()))
        pos += len(toks)
    return out, (np.asarray(kk.astype(jnp.float32)), tk.float().numpy())


STEPS = [[1, 17, 260, 263, 5, 300, 41, 290, 33], [77, 120], [9], [301]]


@pytest.mark.parametrize("kind,rope_scale", [("plain", 1.0), ("tied", 1.0),
                                             ("plain", 0.25)])
def test_forward_matches_jax_f32(ggufs, kind, rope_scale):
    """f32 logits within 1e-5 of max|logit| at every call: a 9-token
    ingest, a 2-token ingest at n_past 9, two single steps; GQA (4 query
    heads on 2 kv heads), tied embeddings, a linear rope_scale (1/4)."""
    jcfg, jp, tcfg, tp = _both(ggufs[kind])
    jcfg = dataclasses.replace(jcfg, rope_scale=rope_scale)
    tcfg = dataclasses.replace(tcfg, rope_scale=rope_scale)
    out, (kk, tk) = _forward_both(jcfg, jp, tcfg, tp, STEPS)
    for i, (j, t) in enumerate(out):
        err = np.abs(j - t).max() / np.abs(j).max()
        assert err < 1e-5, f"call {i}: {err:.3e}"
    np.testing.assert_allclose(tk, kk, atol=1e-5 * np.abs(kk).max())


def test_forward_matches_jax_bf16(ggufs):
    """bf16 weights and activations, JAX compiled with
    xla_allow_excess_precision off (its CPU default drops bf16 roundings
    feeding f32 ops): logits within 1e-2 of max|logit| at each call (bit
    equal at three of the four, 4e-3 at one), the same argmax, the caches
    within 1e-2 of max|k|."""
    jcfg, jp, tcfg, tp = _both(ggufs["plain"], jnp.bfloat16, torch.bfloat16)
    out, (kk, tk) = _forward_both(jcfg, jp, tcfg, tp, STEPS, compile_exact=True)
    for i, (j, t) in enumerate(out):
        err = np.abs(j - t).max() / np.abs(j).max()
        assert err < 1e-2, f"call {i}: {err:.3e}"
        assert j.argmax() == t.argmax(), f"call {i}"
    np.testing.assert_allclose(tk, kk, atol=1e-2 * np.abs(kk).max())


@pytest.fixture(scope="module")
def contexts(ggufs):
    from open_whisper_kit_tpu_torch.models.llama.tokenizer import LlamaVocab
    jctx = LM.LlamaContext(gguf_path=str(ggufs["plain"]), n_ctx=96, dtype=jnp.float32)
    tctx = TL.LlamaContext(gguf_path=str(ggufs["plain"]), n_ctx=96, dtype=torch.float32,
                           device="cpu")
    assert isinstance(tctx.vocab, LlamaVocab)
    return jctx, tctx, tctx.vocab


def _generate(ctx, vocab=None, **kw):
    ctx.reset()
    if vocab is not None:
        ctx.vocab = vocab
    prompt = ctx.vocab.encode(" the cat")
    return ctx.generate(prompt, TL.SampleParams(temp=0.0), **kw), ctx.n_past


@pytest.mark.parametrize("stop", ["max_tokens", "eos", "antiprompt"])
def test_greedy_generate_matches_jax(contexts, stop):
    """LlamaContext.generate in greedy mode, chunk 16, 40 tokens at most:
    the same text and n_past as JAX's, stopping at max_tokens (3 chunks),
    at an eos the greedy path meets in its second chunk, or at an
    antiprompt; one host read for the prompt and one per chunk."""
    jctx, tctx, vocab = contexts
    base, _ = _generate(jctx, vocab, max_tokens=40, chunk=16)
    assert len(base) > 20
    kw = dict(max_tokens=40, chunk=16)
    if stop == "eos":
        # the greedy token at output position 20 becomes the eos id
        ids = _greedy_ids(jctx, 40)
        vocab = dataclasses.replace(vocab, eos_id=ids[20])
    elif stop == "antiprompt":
        kw["antiprompts"] = [base[len(base) // 2:len(base) // 2 + 3]]
    want, jn = _generate(jctx, vocab, **kw)
    reads0 = tctx.reads.n
    got, tn = _generate(tctx, vocab, **kw)
    assert got == want and tn == jn
    n_chunks = -(-(tn - len(vocab.encode(" the cat")) + 1) // 16)
    if stop == "max_tokens":
        assert want == base and n_chunks == 3
    else:
        assert len(want) < len(base)
    assert tctx.reads.n - reads0 == 1 + n_chunks


def _greedy_ids(jctx, n):
    """JAX's greedy ids for " the cat" (stepwise, the reference)."""
    jctx.reset()
    prompt = jctx.vocab.encode(" the cat")
    logits = jctx.eval_tokens(prompt)
    ids = []
    for _ in range(n):
        ids.append(int(np.argmax(logits)))
        logits = jctx.eval_tokens([ids[-1]])
    return ids


def test_greedy_requests_are_not_near_ties(ggufs, contexts):
    """The compared greedy path keeps its tokens when the input embedding is
    scaled by 1 + 2^-20 (JAX, f32): no step sits on a near tie."""
    jcfg, jp, _, _ = _both(ggufs["plain"])
    toks = contexts[0].vocab.encode(" the cat")
    ids = {}
    for scale in (1.0, 1.0 + 2.0 ** -20):
        p = dict(jp, tok_emb=jp["tok_emb"] * scale)
        kk, kv = LM.init_kv_cache(jcfg, 1, 96, jnp.float32)
        logits, kk, kv = LM.forward(jcfg, p, jnp.asarray([toks], jnp.int32), kk, kv,
                                    jnp.asarray(0, jnp.int32))
        out = []
        for i in range(40):
            out.append(int(jnp.argmax(logits[0])))
            logits, kk, kv = LM.forward(jcfg, p, jnp.asarray([[out[-1]]], jnp.int32),
                                        kk, kv, jnp.asarray(len(toks) + i, jnp.int32))
        ids[scale] = out
    assert ids[1.0] == ids[1.0 + 2.0 ** -20]


def test_generate_chunk_keeps_the_state_on_the_device(ggufs):
    """generate_chunk returns device tensors and JAX's n_valid: eos padding
    after the stop, the eos itself counted; the same ids as JAX's chunk."""
    jcfg, jp, tcfg, tp = _both(ggufs["plain"])
    kk, kv = LM.init_kv_cache(jcfg, 1, 64, jnp.float32)
    tk, tv = TL.init_kv_cache(tcfg, 1, 64, torch.float32, device="cpu")
    jt, jn, _, _ = LM.generate_chunk(jcfg, jp, jnp.asarray(5), jnp.asarray(0), kk, kv, 12,
                                     LM.SampleParams(temp=0.0), jax.random.PRNGKey(0),
                                     eos_id=2)
    jt = [int(x) for x in np.asarray(jt)]
    eos = jt[6]
    jt2, jn2, _, _ = LM.generate_chunk(
        jcfg, jp, jnp.asarray(5), jnp.asarray(0), *LM.init_kv_cache(jcfg, 1, 64, jnp.float32),
        12, LM.SampleParams(temp=0.0), jax.random.PRNGKey(0), eos_id=eos)
    for eid, (want, wn) in ((2, (jt, jn)), (eos, (jt2, jn2))):
        tk.zero_(), tv.zero_()
        got, n, _, _ = TL.generate_chunk(tcfg, tp, 5, 0, tk, tv, 12,
                                         TL.SampleParams(temp=0.0), None, eid)
        assert isinstance(got, torch.Tensor) and isinstance(n, torch.Tensor)
        assert got.tolist() == [int(x) for x in np.asarray(want)]
        assert int(n) == int(wn)
    assert int(jn2) < 12 and jt2[int(jn2) - 1] == eos


LOGITS = [np.log(np.asarray([0.40, 0.25, 0.15, 0.08, 0.05, 0.04, 0.03])),
          np.asarray([3.0, 3.0, 2.9, 1.0, 3.0, -1.0, 2.95, 0.5]),
          np.random.default_rng(3).standard_normal(50) * 0.6]
SAMPLERS = [TL.SampleParams(temp=1.0, top_k=5, top_p=0.8, min_p=0.01),
            TL.SampleParams(temp=1.0, top_k=6, top_p=0.99, min_p=0.3),
            TL.SampleParams(temp=0.7, top_k=4, top_p=0.5, min_p=0.0, min_keep=3)]


_DRAWS: dict = {}


def _jax_draws(si):
    """JAX's sampler over 2000 keys, vmapped, for every LOGITS row (padded
    with -inf to one width: never among the top 6): one compile a sampler."""
    if si not in _DRAWS:
        jsp = LM.SampleParams(**dataclasses.asdict(SAMPLERS[si]))
        rows = np.full((len(LOGITS), 50), -np.inf, np.float32)
        for i, row in enumerate(LOGITS):
            rows[i, :len(row)] = row
        keys = jax.random.split(jax.random.PRNGKey(si), 2000)
        draw = jax.vmap(jax.vmap(lambda k, row: LM.sample_token(row, jsp, k),
                                 in_axes=(0, None)), in_axes=(None, 0))
        _DRAWS[si] = np.asarray(jax.jit(draw)(keys, jnp.asarray(rows)))
    return _DRAWS[si]


@pytest.mark.parametrize("li", range(len(LOGITS)))
@pytest.mark.parametrize("si", range(len(SAMPLERS)))
def test_sampler_kept_set_matches_jax(li, si):
    """The filter (top_k -> top_p -> min_p -> min_keep, the lower id first
    among equal logits) keeps the ids JAX's sampler draws over 2000 keys."""
    logits = np.asarray(LOGITS[li], np.float32)
    sp = SAMPLERS[si]
    drawn = _jax_draws(si)[li]
    vals, idx = TL.sample_filter(torch.from_numpy(logits), sp)
    kept = set(idx[torch.isfinite(vals)].tolist())
    assert kept == set(np.asarray(drawn).tolist())
    g = torch.Generator().manual_seed(0)
    draws = {int(TL.sample_token(torch.from_numpy(logits), sp, g)) for _ in range(300)}
    assert draws <= kept


def test_sampled_generate_is_seeded(contexts):
    """A sampled reply depends on the seed alone: the same seed, the same text."""
    _, tctx, vocab = contexts
    sp = TL.SampleParams(temp=0.7, top_k=5)

    def run(seed):
        tctx.reset()
        tctx.vocab = vocab
        return tctx.generate(vocab.encode(" hello"), sp, max_tokens=20, seed=seed,
                             chunk=8)
    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c


def test_llama3_rope_scaling_raises(tmp_path):
    """A Llama-3 GGUF's per-frequency rope scaling ("llama3", with its
    factor keys) is refused by name: the JAX package reads only linear
    scaling, so it loads such a file with the unscaled rotary table
    (a departure, ROADMAP §3). Linear scaling still loads, as in JAX."""
    llama3 = {"scaling.type": "llama3", "scaling.factor": 8.0,
              "scaling.low_freq_factor": 1.0, "scaling.high_freq_factor": 4.0,
              "scaling.original_context_length": 8192.0}
    path = write_gguf(tmp_path / "llama3.gguf", layers=1, rope=llama3)
    with pytest.raises(NotImplementedError, match="llama3"):
        TL.params_from_gguf(load_gguf(path), dtype=torch.float32, device="cpu")
    jcfg, _ = LM.params_from_gguf(jload_gguf(path), dtype=jnp.float32)
    assert jcfg.rope_scale == 1.0           # JAX: silently unscaled
    path = write_gguf(tmp_path / "linear.gguf", layers=1,
                      rope={"scaling.type": "linear", "scaling.factor": 4.0})
    jcfg, _, tcfg, _ = _both(path)
    assert tcfg.rope_scale == jcfg.rope_scale == 0.25


def test_eval_tokens_refuses_past_the_window(contexts):
    tctx = contexts[1]
    tctx.reset()
    with pytest.raises(ValueError, match="exceeds the context window"):
        tctx.eval_tokens([1] * 97)


def test_init_params_shapes_and_device(ggufs):
    """init_params draws the tree params_from_gguf builds, on the device,
    from a seeded generator there."""
    tcfg = _both(ggufs["plain"])[2]
    a = TL.init_params(tcfg, seed=3, dtype=torch.bfloat16, device="cpu")
    b = TL.init_params(tcfg, seed=3, dtype=torch.bfloat16, device="cpu")
    ref = TL.params_from_gguf(load_gguf(ggufs["plain"]), dtype=torch.bfloat16,
                              device="cpu")[1]
    for k in ("tok_emb", "output", "output_norm"):
        assert a[k].shape == ref[k].shape and a[k].dtype == ref[k].dtype
        assert torch.equal(a[k], b[k])
    for k, v in ref["blocks"].items():
        assert a["blocks"][k].shape == v.shape and a["blocks"][k].dtype == v.dtype


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_llama_params_from_jax(dtype):
    """JAX's init_params tree carried over bit for bit, and the same logits
    from it (f32: within 1e-5 of max|logit|)."""
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = LM.LlamaConfig(n_vocab=320, n_ctx=128, n_embd=64, n_layer=2, n_head=4,
                         n_head_kv=2, n_ff=128)
    jp = LM.init_params(cfg, seed=5, dtype=jd)
    tp = TL.llama_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    _assert_same_tree(jp, tp)
    if dtype == "f32":
        tcfg = TL.LlamaConfig(**dataclasses.asdict(cfg))
        out, _ = _forward_both(cfg, jp, tcfg, tp, STEPS[:2])
        for j, t in out:
            assert np.abs(j - t).max() <= 1e-5 * np.abs(j).max()
