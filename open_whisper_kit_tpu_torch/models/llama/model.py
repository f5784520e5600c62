"""LLaMA-family decoder-only transformer in PyTorch (port of
open_whisper_kit_tpu/models/llama/model.py).

Independent reimplementation of the model families the reference's
talk-llama example serves through its vendored llama.cpp
(examples/talk-llama/llama-model.cpp, llm_build_llama):
RMSNorm -> rotary GQA attention -> RMSNorm -> SwiGLU MLP blocks over a
static-shape KV cache, greedy/sampled generation in chunks whose token,
position and stop flag stay on the device (one host read per chunk).

Params are nested dicts of tensors with per-layer weights stacked on a
leading layer axis; matmul weights are stored (in, out) so forward is
``x @ w``, norms stay f32. The rounding points are the JAX module's:
RMSNorm in f32 then cast, cos/sin cast to the activations' dtype, scores
summed in f32, probabilities cast before P·V, SiLU in f32 then cast.

RoPE: ggml's LLAMA arch uses interleaved ("NORM") rotary pairs; HF uses
the half-split layout with permuted q/k rows. We compute the half-split
form and un-permute ggml q/k weights at load time (``_unpermute_rope``).

Sampled tokens draw from a `torch.Generator` on the device, not from
jax.random's threefry stream, so a sampled reply differs from the JAX
package's; the filter that decides which tokens may be drawn (top_k ->
top_p -> min_p -> min_keep) and greedy decoding are the JAX module's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_layer: int
    n_head: int
    n_head_kv: int
    n_ff: int
    rope_freq_base: float = 10000.0
    rms_eps: float = 1e-5
    rope_scale: float = 1.0       # linear position scale (1/factor)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def config_from_gguf(meta: dict) -> LlamaConfig:
    arch = meta.get("general.architecture", "llama")
    g = lambda k, d=None: meta.get(f"{arch}.{k}", d)
    n_embd = int(g("embedding_length"))
    n_head = int(g("attention.head_count"))
    rope_dim = int(g("rope.dimension_count", n_embd // n_head))
    if rope_dim != n_embd // n_head:
        raise NotImplementedError(
            f"partial rotary (rope_dim={rope_dim}) not supported")
    scale = float(g("rope.scale_linear", 0.0)) or 1.0
    if g("rope.scaling.type") == "linear":
        scale = float(g("rope.scaling.factor", 1.0))
    return LlamaConfig(
        n_vocab=int(meta.get("tokenizer.ggml.tokens_len",
                             g("vocab_size", 0)) or g("vocab_size", 0)),
        n_ctx=int(g("context_length", 2048)),
        n_embd=n_embd,
        n_layer=int(g("block_count")),
        n_head=n_head,
        n_head_kv=int(g("attention.head_count_kv", n_head)),
        n_ff=int(g("feed_forward_length")),
        rope_freq_base=float(g("rope.freq_base", 10000.0)),
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_scale=1.0 / scale,
    )


def _unpermute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """ggml (interleaved-RoPE) q/k rows -> HF half-split rows.

    The HF->gguf converter permutes with
    ``w.reshape(h, 2, d/2, in).swapaxes(1, 2)``; this is the inverse.
    w is (out, in) = (h*d, in).
    """
    out, inn = w.shape
    d = out // n_head
    return (w.reshape(n_head, d // 2, 2, inn)
            .swapaxes(1, 2).reshape(out, inn))


def _stack(blocks: list[Params]) -> Params:
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def params_from_gguf(gf, cfg: LlamaConfig | None = None,
                     dtype: torch.dtype = torch.bfloat16, *,
                     device: str | torch.device) -> tuple[LlamaConfig, Params]:
    """Build the params tree from a loaded GGUFFile (io.gguf.load_gguf).

    Quantized tensors are dequantized at load (io.quant handles every
    ggml block format); weights land on `device` as `dtype` with (in, out)
    layout, norms in f32; the output projection is the embedding's
    transpose when the file ties them.
    """
    if cfg is None:
        cfg = config_from_gguf(gf.metadata)
    td = gf.tensors

    def host(a: np.ndarray, dt) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dt)

    def dense(name):  # gguf stores (out, in); we want (in, out)
        return host(td[name].to_float().T, dtype)

    def f32(name):
        return host(td[name].to_float(), torch.float32)

    def qk_dense(name):
        arr = _unpermute_rope(
            td[name].to_float(),
            cfg.n_head if "attn_q" in name else cfg.n_head_kv)
        return host(arr.T, dtype)

    def block(i):
        p = f"blk.{i}."
        return {
            "attn_norm": f32(p + "attn_norm.weight"),
            "wq": qk_dense(p + "attn_q.weight"),
            "wk": qk_dense(p + "attn_k.weight"),
            "wv": dense(p + "attn_v.weight"),
            "wo": dense(p + "attn_output.weight"),
            "ffn_norm": f32(p + "ffn_norm.weight"),
            "w_gate": dense(p + "ffn_gate.weight"),
            "w_up": dense(p + "ffn_up.weight"),
            "w_down": dense(p + "ffn_down.weight"),
        }

    tok_emb = f32("token_embd.weight")          # (V, S)
    if cfg.n_vocab == 0:
        cfg = dataclasses.replace(cfg, n_vocab=tok_emb.shape[0])
    params = {
        "tok_emb": tok_emb.to(dtype),
        "output_norm": f32("output_norm.weight"),
        "output": (dense("output.weight") if "output.weight" in td
                   else tok_emb.t().to(dtype).contiguous()),   # tied embeddings
        "blocks": _stack([block(i) for i in range(cfg.n_layer)]),
    }
    return cfg, params


def init_params(cfg: LlamaConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16, *,
                device: str | torch.device) -> Params:
    """Random params for tests and timing runs (the tree params_from_gguf
    builds), drawn on `device` from a seeded torch.Generator there: a
    full-width model's billions of draws never pass through the host. The
    same seed on another device type draws other numbers."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    S, F, L = cfg.n_embd, cfg.n_ff, cfg.n_layer
    kvd = cfg.n_head_kv * cfg.head_dim

    def w(*shape):      # (..., in, out) scaled by 1/sqrt(in)
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x.mul_(1.0 / math.sqrt(shape[-2])).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    return {
        "tok_emb": w(cfg.n_vocab, S),
        "output_norm": ones(S),
        "output": w(S, cfg.n_vocab),
        "blocks": {
            "attn_norm": ones(L, S),
            "wq": w(L, S, S), "wk": w(L, S, kvd), "wv": w(L, S, kvd),
            "wo": w(L, S, S),
            "ffn_norm": ones(L, S),
            "w_gate": w(L, S, F), "w_up": w(L, S, F), "w_down": w(L, F, S),
        },
    }


def llama_params_from_jax(tree: dict, *, device: str | torch.device) -> Params:
    """The JAX package's llama params (nested dicts of numpy arrays, e.g.
    `jax.tree.map(np.asarray, params)`) -> the port's, bit for bit; the
    layouts are the same."""
    if isinstance(tree, dict):
        return {k: llama_params_from_jax(v, device=device) for k, v in tree.items()}
    a = np.array(tree, copy=True, order="C")   # writable: jax hands out read-only views
    if a.dtype.name == "bfloat16":             # ml_dtypes bf16 from a jax array
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
    return (x32 * w).to(x.dtype)


def _rope_tables(pos: torch.Tensor, cfg: LlamaConfig, dtype: torch.dtype):
    """cos and sin of the half-split rotary embedding at positions `pos`
    (T,), computed in f32 and cast to the activations' dtype: (1, T, 1, d/2)."""
    d = cfg.head_dim
    expo = -torch.arange(0, d // 2, dtype=torch.float32, device=pos.device) * 2.0 / d
    inv = torch.pow(cfg.rope_freq_base, expo)
    theta = (pos.float() * cfg.rope_scale)[:, None] * inv      # (T, d/2)
    return (torch.cos(theta)[None, :, None, :].to(dtype),
            torch.sin(theta)[None, :, None, :].to(dtype))


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding of x: (B, T, H, d)."""
    d = x.shape[-1]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def init_kv_cache(cfg: LlamaConfig, batch: int, n_cache: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: str | torch.device):
    kvd = cfg.n_head_kv * cfg.head_dim
    shape = (cfg.n_layer, batch, n_cache, kvd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor,
            kv_k: torch.Tensor, kv_v: torch.Tensor, pos0):
    """Evaluate `tokens` (B, T) at positions pos0..pos0+T-1 (`pos0` an int
    or a 0-d integer tensor on the device: a tensor keeps the host out).

    Writes their K/V rows into kv_k/kv_v (L, B, n_cache, kvd) in place and
    returns (logits_last (B, V) f32, kv_k, kv_v). One pass serves both
    prompt ingest (T=n) and single-step decode (T=1) — the llama_decode /
    llama_batch analog (talk-llama.cpp:483-499).
    """
    B, T = tokens.shape
    H, HKV, d = cfg.n_head, cfg.n_head_kv, cfg.head_dim
    rep = H // HKV
    n_cache = kv_k.shape[2]
    dev = tokens.device
    pos = torch.as_tensor(pos0, device=dev).long() + torch.arange(T, device=dev)

    x = params["tok_emb"].index_select(0, tokens.reshape(-1)).reshape(B, T, -1)

    # causal-within-window + "nothing past my slot" mask, shared by layers
    slots = torch.arange(n_cache, device=dev)[None, :]
    mask = torch.where(slots <= pos[:, None], 0.0, float("-inf"))   # (T, C) f32
    cos, sin = _rope_tables(pos, cfg, x.dtype)
    scale = math.sqrt(d)

    blocks = params["blocks"]
    for il in range(cfg.n_layer):
        p = {k: v[il] for k, v in blocks.items()}
        h = _rms_norm(x, p["attn_norm"], cfg.rms_eps)
        q = _rope(torch.matmul(h, p["wq"]).reshape(B, T, H, d), cos, sin)
        k = _rope(torch.matmul(h, p["wk"]).reshape(B, T, HKV, d), cos, sin)
        v = torch.matmul(h, p["wv"])
        kv_k[il].index_copy_(1, pos, k.reshape(B, T, HKV * d))
        kv_v[il].index_copy_(1, pos, v)
        ck = kv_k[il].reshape(B, n_cache, HKV, d).transpose(1, 2)    # (B,HKV,C,d)
        cv = kv_v[il].reshape(B, n_cache, HKV, d).transpose(1, 2)

        # GQA: query head h reads kv head h // rep (jnp.repeat's order);
        # the rep query heads of one kv head share its rows, so they are
        # folded into the rows of one product instead of repeating the cache
        qh = q.transpose(1, 2).reshape(B, HKV, rep * T, d)
        scores = torch.matmul(qh.float(), ck.float().transpose(-1, -2)) / scale
        scores = scores.reshape(B, H, T, n_cache)
        probs = torch.softmax(scores + mask, dim=-1).to(x.dtype)
        att = torch.matmul(probs.reshape(B, HKV, rep * T, n_cache), cv)
        att = att.reshape(B, H, T, d).transpose(1, 2).reshape(B, T, H * d)
        x = x + torch.matmul(att, p["wo"])

        h = _rms_norm(x, p["ffn_norm"], cfg.rms_eps)
        g = torch.matmul(h, p["w_gate"])
        x = x + torch.matmul(
            torch.nn.functional.silu(g.float()).to(x.dtype)
            * torch.matmul(h, p["w_up"]), p["w_down"])

    xf = _rms_norm(x[:, -1], params["output_norm"], cfg.rms_eps)
    logits = torch.matmul(xf, params["output"]).float()
    return logits, kv_k, kv_v


# ---------------------------------------------------------------------------
# sampling + chunked generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SampleParams:
    """talk-llama's sampler chain settings (talk-llama.cpp:63-68).

    The reference chains top_k -> top_p -> temp -> dist -> min_p; a
    sampler after `dist` never runs, so min_p is dead there — we apply
    the standard llama.cpp common-sampler order
    (top_k -> top_p -> min_p -> temp -> dist) and document the
    divergence here.
    """
    temp: float = 0.30
    top_k: int = 5
    top_p: float = 0.80
    min_p: float = 0.01
    min_keep: int = 1


def sample_filter(logits: torch.Tensor, sp: SampleParams):
    """The candidates a sampled step may draw from (V,) f32 logits:
    (vals, idx) of the top max(top_k, min_keep, 1) logits in descending
    order (the lower id first among equal values, as lax.top_k), with
    -inf where top_p, min_p and min_keep drop a candidate."""
    k = max(sp.top_k, sp.min_keep, 1)
    vals, idx = torch.sort(logits, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    probs = torch.softmax(vals, -1)
    # top-p: keep the smallest prefix with cumsum >= top_p (min_keep kept)
    csum = torch.cumsum(probs, -1)
    keep = torch.cat([csum.new_zeros(1), csum[:-1]]) < sp.top_p
    # min-p: drop probs < min_p * max (within survivors)
    keep &= probs >= sp.min_p * probs[0]
    keep[:sp.min_keep] = True
    return torch.where(keep, vals, float("-inf")), idx


def sample_token(logits: torch.Tensor, sp: SampleParams,
                 generator: torch.Generator | None) -> torch.Tensor:
    """Sample from (V,) f32 logits on their device: a 0-d int64 tensor."""
    if sp.temp <= 0.0:
        return torch.argmax(logits)
    vals, idx = sample_filter(logits, sp)
    # Gumbel-max draw of the categorical over vals / temp
    u = torch.rand(vals.shape, generator=generator, device=vals.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return idx[torch.argmax(vals / sp.temp + gumbel)]


def generate_chunk(cfg: LlamaConfig, params: Params, first_token, pos0,
                   kv_k, kv_v, n_tokens: int, sp: SampleParams,
                   generator: torch.Generator | None, eos_id: int):
    """Generate up to n_tokens greedily/sampled with no host read.

    Starts from `first_token` (fed as input at pos0). Token, position and
    the stop flag stay on the device for the whole chunk. Returns (tokens
    (n_tokens,) int64 with eos padding after stop, n_valid (0-d), kv_k,
    kv_v), all on the device. The host checks antiprompts between chunks
    (text-level, talk-llama.cpp:707-736).
    """
    dev = kv_k.device
    tok = torch.as_tensor(first_token, device=dev).long().reshape(())
    pos = torch.as_tensor(pos0, device=dev).long().reshape(())
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eos = torch.full((), eos_id, dtype=torch.long, device=dev)
    toks, dones = [], []
    for _ in range(n_tokens):
        logits, kv_k, kv_v = forward(cfg, params, tok.reshape(1, 1), kv_k, kv_v, pos)
        nxt = torch.where(done, eos, sample_token(logits[0], sp, generator))
        done = done | (nxt == eos)
        toks.append(nxt)
        dones.append(done)
        tok, pos = nxt, pos + 1
    dones = torch.stack(dones)
    n_valid = (~dones).sum() + dones.any()        # include the eos itself
    return torch.stack(toks), torch.clamp(n_valid, max=n_tokens), kv_k, kv_v


class LlamaContext:
    """Host-side driver: tokenizer + KV bookkeeping + chunked generation.

    The llama_context / sampler-chain analog for examples/talk.py. With no
    `device` it targets the card and raises without CUDA. `reads` counts
    the device-to-host reads: one per eval_tokens call, one per chunk.
    """

    def __init__(self, gguf_path=None, cfg=None, params=None, vocab=None,
                 n_ctx: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda"):
        from ...decode.device_loop import HostReads
        from ...decode.full import _resolve_device, _to_device
        self.device = _resolve_device(device)
        if gguf_path is not None:
            from ...io.gguf import load_gguf
            from .tokenizer import LlamaVocab
            gf = load_gguf(gguf_path)
            cfg, params = params_from_gguf(gf, dtype=dtype, device=self.device)
            vocab = LlamaVocab.from_gguf_metadata(gf.metadata)
        else:
            params = _to_device(params, self.device)
        self.cfg, self.params, self.vocab = cfg, params, vocab
        self.n_ctx = min(n_ctx, cfg.n_ctx)
        self.reads = HostReads()
        self.kv_k, self.kv_v = init_kv_cache(cfg, 1, self.n_ctx, dtype,
                                             device=self.device)
        self.n_past = 0

    def reset(self):
        self.kv_k, self.kv_v = init_kv_cache(
            self.cfg, 1, self.n_ctx, self.kv_k.dtype, device=self.device)
        self.n_past = 0

    def eval_tokens(self, tokens: list[int]) -> np.ndarray:
        """Prompt ingest; returns last-position logits (V,) f32."""
        if self.n_past + len(tokens) > self.n_ctx:
            raise ValueError(
                f"prompt of {len(tokens)} tokens at n_past={self.n_past} "
                f"exceeds the context window ({self.n_ctx}); shorten the "
                f"prompt or raise n_ctx")
        logits = None
        for i in range(0, len(tokens), 512):     # bounded ingest shapes
            chunk = tokens[i:i + 512]
            toks = torch.tensor([chunk], dtype=torch.long, device=self.device)
            logits, self.kv_k, self.kv_v = forward(
                self.cfg, self.params, toks, self.kv_k, self.kv_v, self.n_past)
            self.n_past += len(chunk)
        return self.reads.fetch(logits[0])

    def generate(self, prompt_tokens, sp: SampleParams, *, max_tokens: int,
                 antiprompts=(), seed: int = 0, chunk: int = 16,
                 on_piece=None) -> str:
        """talk-llama's inference loop: eval prompt, then sample until an
        antiprompt / eos / max_tokens; device work batched per chunk."""
        assert prompt_tokens, "empty prompt"
        if len(prompt_tokens) > 1:
            self.eval_tokens(prompt_tokens[:-1])
        first = prompt_tokens[-1]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        text = ""
        n_out = 0
        eos = self.vocab.eos_id
        while n_out < max_tokens:
            n = min(chunk, max_tokens - n_out,
                    self.n_ctx - 1 - (self.n_past + 1))
            if n <= 0:
                break
            toks, n_valid, self.kv_k, self.kv_v = generate_chunk(
                self.cfg, self.params, first, self.n_past, self.kv_k,
                self.kv_v, n, sp, gen, eos)
            host = self.reads.fetch(torch.cat([toks, n_valid.reshape(1)]))
            toks = host[:int(host[-1])]
            self.n_past += len(toks)
            stopped = len(toks) and toks[-1] == eos
            new = "".join(self.vocab.piece(int(t)) for t in toks)
            text += new
            if on_piece and new:
                on_piece(new)
            n_out += len(toks)
            for ap in antiprompts:
                j = text.find(ap)
                if j != -1:
                    return text[:j]
            if stopped or len(toks) < n:
                break
            first = int(toks[-1])
        return text
