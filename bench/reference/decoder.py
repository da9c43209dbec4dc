"""Plain float32 dense decoder embedder: the reference the embeddings of a
Llama-architecture configuration are held to.

The published Llama-architecture layer (Yi-9B follows it, arXiv:2403.04652):
pre-norm RMSNorm, grouped-query causal attention with rotary position
embeddings (rotate-half, base ``rope_theta``), a SwiGLU MLP, a final
RMSNorm; the embedding is the hidden states' mean over the sequence,
scaled to unit length.  Everything in float32 with TF32 off, one layer at a
time: each layer's weights are drawn again from the seed
(``bench/lib/inputs.py``, the same draw the benchmark handed the program)
and dropped before the next.  ``precision="fp8"`` is the control: every
matrix product's inputs rounded to float8 e4m3 with one scale per tensor,
the sums in float32.  It imports nothing of the program.

A reference module of another architecture exports the same three
functions: ``layer_parameters``, ``embed`` and ``flops_per_token``; its
``embed`` may run its own layer through ``pooled_embeddings``.
"""

from __future__ import annotations

import math

import torch

from bench.lib import inputs, yardstick

E4M3_MAX = 448.0


def layer_parameters(model: dict, layer: int) -> list[tuple[str, tuple[int, ...], float | str]]:
    """(name under ``layers.<layer>.`` in the port's state dict, shape,
    init) of one layer, in the order they are drawn: the matrices at
    1/sqrt(fan-in), then the two RMSNorm scales."""
    d = model["hidden_size"]
    hd = model.get("head_dim") or d // model["num_attention_heads"]
    q, kv, f = model["num_attention_heads"] * hd, model["num_key_value_heads"] * hd, model["intermediate_size"]
    return [
        ("attn.w_q", (d, q), 1 / math.sqrt(d)),
        ("attn.w_k", (d, kv), 1 / math.sqrt(d)),
        ("attn.w_v", (d, kv), 1 / math.sqrt(d)),
        ("attn.w_o", (q, d), 1 / math.sqrt(q)),
        ("mlp.w_gate", (d, f), 1 / math.sqrt(d)),
        ("mlp.w_up", (d, f), 1 / math.sqrt(d)),
        ("mlp.w_down", (f, d), 1 / math.sqrt(f)),
        ("ln_attn", (d,), "norm"),
        ("ln_mlp", (d,), "norm"),
    ]


# Model FLOPs of one token to the final norm.
flops_per_token = yardstick.decoder_flops_per_token


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32, or with both inputs rounded to fp8 (the control)."""
    if precision == "fp8":
        return _fp8(a) @ _fp8(b)
    return a @ b


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd]: rotate-half rotary embedding at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q [B, S, H, hd], k and v [B, S, KVH, hd] -> [B, S, H * hd]."""
    b, s, h, hd = q.shape
    k = k.repeat_interleave(h // k.shape[2], dim=2)
    v = v.repeat_interleave(h // v.shape[2], dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, -1)


def swiglu(x: torch.Tensor, w: dict, precision: str) -> torch.Tensor:
    gate = torch.nn.functional.silu(mm(x, w["mlp.w_gate"], precision))
    return mm(gate * mm(x, w["mlp.w_up"], precision), w["mlp.w_down"], precision)


def _layer(x: torch.Tensor, w: dict, model: dict, precision: str) -> torch.Tensor:
    b, s, d = x.shape
    hd = model.get("head_dim") or d // model["num_attention_heads"]
    h, kvh = model["num_attention_heads"], model["num_key_value_heads"]
    eps = model["rms_norm_eps"]
    a = rms(x, w["ln_attn"], eps)
    q = rope(mm(a, w["attn.w_q"], precision).view(b, s, h, hd), model["rope_theta"])
    k = rope(mm(a, w["attn.w_k"], precision).view(b, s, kvh, hd), model["rope_theta"])
    v = mm(a, w["attn.w_v"], precision).view(b, s, kvh, hd)
    x = x + mm(causal_attention(q, k, v), w["attn.w_o"], precision)
    return x + swiglu(rms(x, w["ln_mlp"], eps), w, precision)


def pooled_embeddings(tokens: torch.Tensor, model: dict, seed: int, device, parameters_of, layer_fn,
                      precision: str = "float32", block: int = 16) -> torch.Tensor:
    """Unit-length embeddings [B, d] (float32) of ``tokens`` [B, S]: the
    drawn token embedding, each of ``num_hidden_layers`` layers as
    ``layer_fn(x, weights, model, precision)`` with the weights
    ``parameters_of(model, layer)`` lists (drawn again, in float32), the final
    RMSNorm and the mean over the sequence; in blocks of ``block``
    documents, with TF32 off."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            tokens = torch.as_tensor(tokens, device=device, dtype=torch.int64)
            table = inputs.embedding_table(model, device, seed)
            xs = [table[tokens[lo:lo + block]].float() for lo in range(0, len(tokens), block)]
            del table
            for layer in range(model["num_hidden_layers"]):
                drawn = inputs.layer_weights(parameters_of(model, layer), layer, device, seed)
                w = {n: t.float() for n, t in drawn.items()}
                del drawn
                xs = [layer_fn(x, w, model, precision) for x in xs]
                del w
            scale = inputs.final_norm(model, device, seed).float()
            out = torch.cat([rms(x, scale, model["rms_norm_eps"]).mean(1) for x in xs])
            return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def embed(tokens: torch.Tensor, model: dict, seed: int, device, precision: str = "float32",
          block: int = 16) -> torch.Tensor:
    """Unit-length embeddings [B, d] (float32) of ``tokens`` [B, S], in
    blocks of ``block`` documents."""
    return pooled_embeddings(tokens, model, seed, device, layer_parameters, _layer, precision, block)
