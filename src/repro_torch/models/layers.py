"""Transformer building blocks in PyTorch: RMSNorm, RoPE, flash attention
(online softmax over KV blocks), GQA / MQA with the qk-norm and qkv-bias
options, multi-head latent attention (MLA), the SwiGLU MLP; mirrors
``repro.models.layers``.

Weights keep the reference's layout (``x @ w``, ``w`` as [d_in, d_out]) and
dtype (bf16), so a parameter tree carries over unchanged
(``models/convert.py``).  Products of bf16 operands accumulate in float32
where the reference asks for it (``preferred_element_type``): the operands
are widened first, which is exact for bf16.

Under a mesh policy (``distributed.act_sharding``) the modules hold local
shards, and the blocks run on them: attention heads and MLP columns split
over ``model`` where they divide (column-parallel ``w_q`` / ``w_k`` /
``w_v`` / ``w_uq`` / ``w_ukv`` / ``w_gate`` / ``w_up``, row-parallel
``w_o`` / ``w_down`` followed by a float32 sum over ``model``), the KV
heads repeated up to the tensor-parallel width where ``kvh < tp <= h`` (the
reference's partial KV repeat: each rank computes the one KV head its
query heads read), every other weight gathered (``act_sharding.weight``).
Outside a policy the weights are used as they are.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..distributed import act_sharding as shd
from .config import ModelConfig

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16

DEFAULT_KV_BLOCK = 1_024
DEFAULT_Q_BLOCK = 2_048

_COST_TILES = []


@contextlib.contextmanager
def cost_tiles():
    """Enlarge flash attention's tiles (at most 8 KV and 4 query blocks per
    sequence), as the reference does in its cost pass: the operations do
    not depend on the blocking, and fewer blocks are fewer dispatches."""
    _COST_TILES.append(True)
    try:
        yield
    finally:
        _COST_TILES.pop()


# ----------------------------------------------------------------- norms --
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ------------------------------------------------------------------ rope --
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               freqs: torch.Tensor | None = None, cos_scale: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] (int).  Rotate-half RoPE at
    ``rope_freqs(hd, theta)``, or at the inverse frequencies ``freqs``
    [hd/2] with cos and sin scaled by ``cos_scale`` (YaRN)."""
    if freqs is None:
        freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # [hd/2]
    angles = positions[..., :, None].float() * freqs[None, :]  # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    if cos_scale != 1.0:
        cos, sin = cos * cos_scale, sin * cos_scale
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def yarn_mscale(scale: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 * mscale * ln(scale) + 1,
    and 1 where the scale does not stretch."""
    return 1.0 if scale <= 1.0 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_ramp_bounds(cfg: ModelConfig, dim: int) -> tuple[int, int]:
    """(low, high): the dimensions where YaRN's ramp starts and ends,
    floor / ceil of dim * ln(L / (2 pi r)) / (2 ln theta) at r = beta_fast /
    beta_slow rotations over the original L positions, kept in [0, dim-1]."""
    def correction(rotations: float) -> float:
        return dim * math.log(cfg.rope_yarn_original_max_positions / (rotations * 2 * math.pi)) \
            / (2 * math.log(cfg.rope_theta))

    return (max(math.floor(correction(cfg.rope_yarn_beta_fast)), 0),
            min(math.ceil(correction(cfg.rope_yarn_beta_slow)), dim - 1))


def yarn_inv_freqs(cfg: ModelConfig, dim: int, device=None) -> torch.Tensor:
    """YaRN's inverse frequencies [dim/2], as DeepSeek-V2 publishes them:
    theta^(-2i/dim) (1 - ramp_i) + theta^(-2i/dim) / factor * ramp_i, the
    ramp linear from 0 at ``low`` to 1 at ``high`` (``yarn_ramp_bounds``)."""
    low, high = yarn_ramp_bounds(cfg, dim)
    extra = rope_freqs(dim, cfg.rope_theta, device=device)
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / max(high - low, 1e-3)
    ramp = ramp.clamp(0.0, 1.0)
    return extra * (1.0 - ramp) + extra / cfg.rope_yarn_factor * ramp


def rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``apply_rope`` at the configuration's theta, YaRN-scaled where it
    has a YaRN factor (cos and sin then scaled by mscale / mscale_all_dim)."""
    if not cfg.rope_yarn_factor:
        return apply_rope(x, positions, cfg.rope_theta)
    f = cfg.rope_yarn_factor
    return apply_rope(x, positions, cfg.rope_theta, yarn_inv_freqs(cfg, x.shape[-1], x.device),
                      yarn_mscale(f, cfg.rope_yarn_mscale) / yarn_mscale(f, cfg.rope_yarn_mscale_all_dim))


def softmax_scale(cfg: ModelConfig, head_dim: int) -> float | None:
    """The attention softmax's scale where it is not 1/sqrt(head_dim):
    DeepSeek-V2's YaRN multiplies it by mscale(factor, mscale_all_dim)^2.
    None for the default."""
    if not (cfg.rope_yarn_factor and cfg.rope_yarn_mscale_all_dim):
        return None
    return head_dim ** -0.5 * yarn_mscale(cfg.rope_yarn_factor, cfg.rope_yarn_mscale_all_dim) ** 2


# -------------------------------------------------------- flash attention --
def _pad_seq(x: torch.Tensor, to: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, 0, to - x.shape[1]))


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Sk, KVH, hd]  (KVH divides H: GQA / MQA)
    v: torch.Tensor,  # [B, Sk, KVH, vd]
    causal_offset: int | None = 0,
    kv_block: int = DEFAULT_KV_BLOCK,
    q_block: int = DEFAULT_Q_BLOCK,
    scale: float | None = None,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks, O(Sq * blk) live memory.

    Queries are grouped [B, qb, KVH, G, hd] and contracted against the raw
    KV heads, which are never repeated to H.  Both sequences are padded to
    whole blocks; padded keys are masked.  ``causal_offset``: query i
    attends to keys j <= i + offset; None disables the causal mask.
    ``scale`` is the softmax's (default 1/sqrt(hd)).  Scores,
    the running (max, denominator, accumulator) and the value product are
    float32; the output takes ``q``'s dtype."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if _COST_TILES:
        kv_block = max(kv_block, -(-sk // 8))
        q_block = max(q_block, -(-sq // 4))
    kv_block = min(kv_block, sk)
    q_block = min(q_block, sq)
    n_kv = -(-sk // kv_block)
    n_q = -(-sq // q_block)
    qp = _pad_seq(q, n_q * q_block).float()
    kb = _pad_seq(k, n_kv * kv_block).float().reshape(b, n_kv, kv_block, kvh, hd)
    vb = _pad_seq(v, n_kv * kv_block).float().reshape(b, n_kv, kv_block, kvh, vd)
    dev = q.device
    outs = []
    for qi in range(n_q):
        q5 = qp[:, qi * q_block:(qi + 1) * q_block].reshape(b, q_block, kvh, g, hd)
        q_pos = qi * q_block + torch.arange(q_block, device=dev)
        m = torch.full((b, kvh, g, q_block), float("-inf"), device=dev)
        l = torch.zeros((b, kvh, g, q_block), device=dev)
        acc = torch.zeros((b, kvh, g, q_block, vd), device=dev)
        for kj in range(n_kv):
            s = torch.einsum("bqkgd,bekd->bkgqe", q5, kb[:, kj]) * scale  # [B,KVH,G,qb,kb]
            k_pos = kj * kv_block + torch.arange(kv_block, device=dev)
            mask = (k_pos < sk)[None, :]  # padding
            if causal_offset is not None:
                mask = mask & (k_pos[None, :] <= q_pos[:, None] + causal_offset)
            s = s.masked_fill(~mask, -1e30)  # a scalar: no host-to-device copy, no sync
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqe,bekd->bkgqd", p, vb[:, kj])
            m = m_new
        out = acc / l[..., None].clamp_min(1e-30)  # [B,KVH,G,qb,vd]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, vd))
    return torch.cat(outs, 1)[:, :sq].to(q.dtype)


def repeat_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, KVH, hd] -> [B, S, H, hd] by repeating each kv head."""
    kvh = x.shape[2]
    if kvh == num_heads:
        return x
    return x.repeat_interleave(num_heads // kvh, dim=2)


# ------------------------------------------------------------ parameters --
def model_device(device="cuda") -> torch.device:
    """``resolve_device``, save that ``"meta"`` passes: a shape-only model
    that ``load_state_dict(..., assign=True)`` then fills."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _normal(shape, scale: float, generator, device, dtype=PARAM_DTYPE) -> nn.Parameter:
    """A normal draw times ``scale``, both in ``dtype`` (bf16 by default,
    as the reference).  On the meta device (``model.params_shape``) an
    empty tensor: a draw there has no values and its first call imports
    sympy (seconds of set-up)."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return nn.Parameter(w.mul_(scale), requires_grad=False)


def _const(n: int, value: float, device, dtype=PARAM_DTYPE) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), value, dtype=dtype, device=device), requires_grad=False)


class Attention(nn.Module):
    """Self-attention weights (``init_attention_params``): GQA / MQA, or
    MLA's low-rank key-value projection with a low-rank query (``w_dq``,
    ``q_norm``, ``w_uq``) or, where ``q_lora_rank`` is 0, one direct query
    projection ``w_q`` (DeepSeek-V2-Lite's ``q_proj``; the reference has
    no such path)."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        d = cfg.d_model
        s = 1.0 / math.sqrt(d)
        if cfg.attn_type == "mla":
            qr = cfg.q_lora_rank
            qhd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            r, h = cfg.kv_lora_rank, cfg.num_heads
            if qr:
                self.w_dq = _normal((d, qr), s, generator, device)
                self.q_norm = _const(qr, 1.0, device)
                self.w_uq = _normal((qr, h * qhd), 1.0 / math.sqrt(qr), generator, device)
            else:
                self.w_q = _normal((d, h * qhd), s, generator, device)
            self.w_dkv = _normal((d, r + cfg.qk_rope_head_dim), s, generator, device)
            self.kv_norm = _const(r, 1.0, device)
            self.w_ukv = _normal((r, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                                 1.0 / math.sqrt(r), generator, device)
            self.w_o = _normal((h * cfg.v_head_dim, d), 1.0 / math.sqrt(h * cfg.v_head_dim),
                               generator, device)
            return
        self.w_q = _normal((d, cfg.q_dim), s, generator, device)
        self.w_k = _normal((d, cfg.kv_dim), s, generator, device)
        self.w_v = _normal((d, cfg.kv_dim), s, generator, device)
        self.w_o = _normal((cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim), generator, device)
        if cfg.qkv_bias:
            self.b_q = _const(cfg.q_dim, 0.0, device)
            self.b_k = _const(cfg.kv_dim, 0.0, device)
            self.b_v = _const(cfg.kv_dim, 0.0, device)
        if cfg.qk_norm:
            self.q_head_norm = _const(cfg.head_dim, 1.0, device)
            self.k_head_norm = _const(cfg.head_dim, 1.0, device)


def _split_in(x: torch.Tensor, tp: int) -> torch.Tensor:
    return shd.copy_to(x) if tp > 1 else x


def _split_out(x: torch.Tensor, tp: int) -> torch.Tensor:
    """The sum over ``model`` of row-parallel partial outputs, in float32."""
    return shd.reduce_from(x.float()).to(x.dtype) if tp > 1 else x


def gqa_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor):
    """Project to (q [B,S,H,hd], k [B,S,KVH,hd], v [B,S,KVH,hd]) with rope;
    under a head-parallel policy this rank's H / tp query heads and the KV
    heads they read."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    tp = shd.head_parallel(cfg)
    keep = "keep" if tp > 1 else "slice"
    x = _split_in(x, tp)
    heads = cfg.num_heads // tp
    names = ("w_k", "w_v") + (("b_k", "b_v") if cfg.qkv_bias else ())
    if cfg.num_kv_heads % tp:  # partial KV repeat: the one KV head this rank's query heads read
        j = shd.axis_rank("model") * heads // (cfg.num_heads // cfg.num_kv_heads)
        kv = {n: shd.weight(p, n, "sum")[..., j * hd:(j + 1) * hd] for n in names}
        kv_heads = 1
    else:
        kv = {n: shd.weight(p, n, keep) for n in names}
        kv_heads = cfg.num_kv_heads // tp
    q = x @ shd.weight(p, "w_q", keep)
    k = x @ kv["w_k"]
    v = x @ kv["w_v"]
    if cfg.qkv_bias:
        q = q + shd.weight(p, "b_q", keep)
        k = k + kv["b_k"]
        v = v + kv["b_v"]
    q = q.reshape(b, s, heads, hd)
    k = k.reshape(b, s, kv_heads, hd)
    v = v.reshape(b, s, kv_heads, hd)
    if cfg.qk_norm:
        norm_mode = "sum" if tp > 1 else "slice"  # a replicated scale on this rank's heads
        q = rms_norm(q, shd.weight(p, "q_head_norm", norm_mode), cfg.norm_eps)
        k = rms_norm(k, shd.weight(p, "k_head_norm", norm_mode), cfg.norm_eps)
    q = rope(cfg, q, positions)
    k = rope(cfg, k, positions)
    return q, k, v


def mla_query(cfg: ModelConfig, p: Attention, x: torch.Tensor, tp: int) -> torch.Tensor:
    """MLA's query [B, S, heads * (nope+rope)] before RoPE: the low-rank
    ``w_dq`` -> ``q_norm`` -> ``w_uq``, or the direct ``w_q``."""
    keep = "keep" if tp > 1 else "slice"
    if cfg.q_lora_rank:
        cq = rms_norm(x @ shd.weight(p, "w_dq"), p.q_norm, cfg.norm_eps)
        return _split_in(cq, tp) @ shd.weight(p, "w_uq", keep)
    return _split_in(x, tp) @ shd.weight(p, "w_q", keep)


def mla_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor):
    """MLA projections.  Returns (q [B,S,H,nope+rope], k [B,S,H,nope+rope],
    v [B,S,H,vd], the cache payload c [B,S,kv_lora+rope]); under a
    head-parallel policy this rank's H / tp heads (the low-rank projections
    and the payload replicated).

    The payload is the compressed c_kv followed by the shared rope key
    *after* RoPE: what a serving cache stores and the absorbed decode
    reads.  k and v are the decompressed views."""
    b, s, _ = x.shape
    tp = shd.head_parallel(cfg)
    keep = "keep" if tp > 1 else "slice"
    h = cfg.num_heads // tp
    nope, rope_d, vd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q = mla_query(cfg, p, x, tp).reshape(b, s, h, nope + rope_d)
    q = torch.cat([q[..., :nope], rope(cfg, q[..., nope:], positions)], -1)
    dkv = x @ shd.weight(p, "w_dkv")  # [B,S,r+rope]
    c_kv = rms_norm(dkv[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = rope(cfg, dkv[..., r:].reshape(b, s, 1, rope_d), positions)
    ukv = (_split_in(c_kv, tp) @ shd.weight(p, "w_ukv", keep)).reshape(b, s, h, nope + vd)
    k = torch.cat([ukv[..., :nope], _split_in(k_rope, tp).expand(b, s, h, rope_d)], -1)
    return q, k, ukv[..., nope:], torch.cat([c_kv, k_rope[:, :, 0]], -1)


def attention_block(
    cfg: ModelConfig, p: Attention, x: torch.Tensor, positions: torch.Tensor,
    kv_block: int = DEFAULT_KV_BLOCK,
) -> torch.Tensor:
    """Full causal self-attention for a whole sequence."""
    b, s = x.shape[:2]
    if cfg.attn_type == "mla":
        q, k, v, _payload = mla_qkv(cfg, p, x, positions)
    else:
        q, k, v = gqa_qkv(cfg, p, x, positions)
    out = flash_attention(q, k, v, causal_offset=0, kv_block=kv_block, scale=softmax_scale(cfg, q.shape[-1]))
    return attention_out(cfg, p, out.reshape(b, s, -1))


def attention_out(cfg: ModelConfig, p: Attention, out: torch.Tensor) -> torch.Tensor:
    """The output projection of the heads' outputs [B, S, heads * vd]:
    row parallel (then summed over ``model``) under a head-parallel
    policy."""
    tp = shd.head_parallel(cfg)
    return _split_out(out @ shd.weight(p, "w_o", "keep" if tp > 1 else "slice"), tp)


# ------------------------------------------------------------------- MLP --
class MLP(nn.Module):
    """SwiGLU weights (``init_mlp_params``)."""

    def __init__(self, d: int, f: int, generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.w_gate = _normal((d, f), 1.0 / math.sqrt(d), generator, device)
        self.w_up = _normal((d, f), 1.0 / math.sqrt(d), generator, device)
        self.w_down = _normal((f, d), 1.0 / math.sqrt(f), generator, device)


def mlp_split(p: MLP) -> int:
    """The number of ranks the MLP's hidden columns split over (1: it runs
    replicated)."""
    both = shd.is_split(p, "w_gate") and shd.is_split(p, "w_down")
    return shd.model_axis_size() if both else 1


def mlp_partial(p: MLP, x: torch.Tensor, tp: int) -> torch.Tensor:
    """The SwiGLU MLP on this rank's hidden columns (all of them at tp 1):
    a partial output that the caller sums over ``model``."""
    keep = "keep" if tp > 1 else "slice"
    x = _split_in(x, tp)
    return (F.silu(x @ shd.weight(p, "w_gate", keep)) * (x @ shd.weight(p, "w_up", keep))) @ shd.weight(p, "w_down", keep)


def mlp_block(p: MLP, x: torch.Tensor) -> torch.Tensor:
    tp = mlp_split(p)
    return _split_out(mlp_partial(p, x, tp), tp)
