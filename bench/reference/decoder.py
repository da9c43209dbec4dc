"""Plain float32 dense decoder embedder: the reference the embeddings are
held to.

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
"""

from __future__ import annotations

import math

import torch

from bench.lib import inputs

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _fp8(a) @ _fp8(b)
    return a @ b


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd]: rotate-half rotary embedding at positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x: torch.Tensor, w: dict, model: dict, precision: str) -> torch.Tensor:
    b, s, d = x.shape
    hd = model.get("head_dim") or d // model["num_attention_heads"]
    h, kvh = model["num_attention_heads"], model["num_key_value_heads"]
    eps = model["rms_norm_eps"]
    a = _rms(x, w["ln_attn"], eps)
    q = _rope(_mm(a, w["attn.w_q"], precision).view(b, s, h, hd), model["rope_theta"])
    k = _rope(_mm(a, w["attn.w_k"], precision).view(b, s, kvh, hd), model["rope_theta"])
    v = _mm(a, w["attn.w_v"], precision).view(b, s, kvh, hd)
    k = k.repeat_interleave(h // kvh, dim=2)
    v = v.repeat_interleave(h // kvh, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * hd)
    x = x + _mm(out, w["attn.w_o"], precision)
    m = _rms(x, w["ln_mlp"], eps)
    gate = torch.nn.functional.silu(_mm(m, w["mlp.w_gate"], precision))
    return x + _mm(gate * _mm(m, w["mlp.w_up"], precision), w["mlp.w_down"], precision)


def embed(tokens: torch.Tensor, model: dict, seed: int, device, precision: str = "float32",
          block: int = 16) -> torch.Tensor:
    """Unit-length embeddings [B, d] (float32) of ``tokens`` [B, S], in
    blocks of ``block`` documents."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            tokens = torch.as_tensor(tokens, device=device, dtype=torch.int64)
            table = inputs.embedding_table(model, device, seed)
            xs = [table[tokens[lo:lo + block]].float() for lo in range(0, len(tokens), block)]
            del table
            for layer in range(model["num_hidden_layers"]):
                w = {n: t.float() for n, t in inputs.layer_weights(model, layer, device, seed).items()}
                xs = [_layer(x, w, model, precision) for x in xs]
                del w
            scale = inputs.final_norm(model, device, seed).float()
            out = torch.cat([_rms(x, scale, model["rms_norm_eps"]).mean(1) for x in xs])
            return out / torch.linalg.vector_norm(out, dim=1, keepdim=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
