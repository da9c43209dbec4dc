"""Mamba2 / SSD (state-space duality) block; mirrors ``repro.models.ssm``.

Chunked SSD (Dao & Gu 2024): the sequence is split into chunks of Q
tokens; within a chunk the output is a masked quadratic form, across
chunks a recurrent state [B, H, hd, N] is carried by a loop over the
chunks.  Decode is the O(1) recurrence ``h = a·h + dt·B⊗x``,
``y = C·h + D·x``.  Single-group B / C (G=1), a scalar A per head.

The scan and the decode run in float32; ``a_log``, ``d_skip`` and
``dt_bias`` are float32 parameters, as in the reference.  The reference's
``scan_util`` (a ``lax.scan`` / unroll switch) has no counterpart: the
chunk loop is a Python loop, each chunk recomputed in the backward pass.
Under a mesh policy the block runs replicated over ``model``, its
projections gathered (``act_sharding.weight``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import act_sharding as shd
from .config import ModelConfig
from .layers import PARAM_DTYPE, _const, _normal, model_device, rms_norm


class SSM(nn.Module):
    """``init_ssm_params``: in_proj emits [z (di), x (di), B (n), C (n),
    dt (h)]; a depthwise causal conv over x, B, C; out_proj."""

    def __init__(self, cfg: ModelConfig, generator=None, device="cuda"):
        super().__init__()
        device = model_device(device)
        d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        self.w_in = _normal((d, 2 * di + 2 * n + h), 1.0 / math.sqrt(d), generator, device)
        self.conv_w = _normal((cfg.ssm_conv, di + 2 * n), 0.1, generator, device)
        self.conv_b = _const(di + 2 * n, 0.0, device)
        a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device))
        self.a_log = nn.Parameter(a_log, requires_grad=False)
        self.d_skip = _const(h, 1.0, device, torch.float32)
        self.dt_bias = _const(h, 0.0, device, torch.float32)
        self.norm = _const(di, 1.0, device)
        self.w_out = _normal((di, d), 1.0 / math.sqrt(di), generator, device)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * n], proj[..., 2 * di + 2 * n:]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over [B, S, C] with window len(w): the taps
    summed in float32 in tap order, SiLU, cast back."""
    conv, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, conv - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(conv):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _ssd_chunk(xf, dtj, bj, cj, cumj, tri, h_state):
    """One chunk of the SSD scan: (y [B,Q,H,hd], the state after it)."""
    # L[b,h,t,u] = exp(cum_t - cum_u) for t >= u.  Clamp before exp: the
    # masked (t < u) region has diff > 0, whose exp can overflow, and
    # inf * 0 = NaN.
    ch = cumj.transpose(1, 2)  # [B,H,Q]
    diff = ch[:, :, :, None] - ch[:, :, None, :]
    l_mat = torch.exp(torch.clamp_max(diff, 0.0)) * tri
    cb = torch.einsum("btn,bun->btu", cj, bj)  # [B,Q,Q]
    w_tu = cb[:, None] * l_mat * dtj.transpose(1, 2)[:, :, None, :]  # fold dt_u
    y_diag = torch.einsum("bhtu,buhd->bthd", w_tu, xf)
    cd = cj[:, :, None, :] * torch.exp(cumj)[..., None]  # [B,Q,H,N]
    y_off = torch.einsum("bthn,bhdn->bthd", cd, h_state)
    total = cumj[:, -1]  # [B,H]
    xw = xf * (torch.exp(total[:, None] - cumj) * dtj)[..., None]
    h_state = torch.exp(total)[:, :, None, None] * h_state + torch.einsum("bun,buhd->bhdn", bj, xw)
    return y_diag + y_off, h_state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
                c_in: torch.Tensor, chunk: int, h_init: torch.Tensor | None = None):
    """Chunked SSD scan.  x [B,S,H,hd], dt [B,S,H] (after softplus), a [H]
    (negative), b_in / c_in [B,S,N].  Returns (y [B,S,H,hd] in x's dtype,
    final state [B,H,hd,N] float32).  The sequence is padded to whole
    chunks (padded steps have dt = 0, so they leave the state alone).  When
    autograd records, each chunk keeps only its inputs and is recomputed
    in the backward pass, as the reference checkpoints its chunk step."""
    bsz, s, h, hd = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, hd)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b_in.reshape(bsz, nc, chunk, n).float()
    cc = c_in.reshape(bsz, nc, chunk, n).float()
    cum = torch.cumsum(dtc * a, dim=2)  # within-chunk cumulative log decay [B,nc,Q,H]
    tri = torch.ones((chunk, chunk), dtype=torch.float32, device=x.device).tril()
    h_state = (h_init.float() if h_init is not None
               else torch.zeros((bsz, h, hd, n), dtype=torch.float32, device=x.device))
    recompute = torch.is_grad_enabled()
    ys = []
    for j in range(nc):
        args = (xc[:, j].float(), dtc[:, j], bc[:, j], cc[:, j], cum[:, j], tri, h_state)
        if recompute:  # the reference's jax.checkpoint of the chunk step
            y, h_state = shd.checkpoint(_ssd_chunk, *args)
        else:
            y, h_state = _ssd_chunk(*args)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(bsz, s + pad, h, hd)[:, :s]
    return y.to(x.dtype), h_state


def _ssm_core(cfg: ModelConfig, p: SSM, x: torch.Tensor, h_init=None):
    """in_proj, conv, scan, skip, gate, norm, out_proj over x [B,S,D].
    Returns (out, final state, the pre-conv xbc)."""
    bsz, s, _ = x.shape
    di, n, h, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, x @ shd.weight(p, "w_in"))
    xbc_conv = _causal_conv(xbc, p.conv_w, p.conv_b)
    xs = xbc_conv[..., :di].reshape(bsz, s, h, hd)
    dt = F.softplus(dt.float() + p.dt_bias)  # [B,S,H]
    y, h_final = ssd_chunked(xs, dt, -torch.exp(p.a_log), xbc_conv[..., di:di + n],
                             xbc_conv[..., di + n:], cfg.ssm_chunk, h_init)
    y = y + xs * p.d_skip[None, None, :, None].to(x.dtype)
    y = rms_norm(y.reshape(bsz, s, di) * F.silu(z), p.norm, cfg.norm_eps)
    return y @ shd.weight(p, "w_out"), h_final, xbc


def ssm_block(cfg: ModelConfig, p: SSM, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD block (prefill, hidden states)."""
    return _ssm_core(cfg, p, x)[0]


def ssm_block_with_state(cfg: ModelConfig, p: SSM, x: torch.Tensor, state: dict):
    """Prefill variant: (out, {"h": final state float32, "conv": the last
    conv - 1 *pre-conv* inputs, left-padded with zeros when S < conv - 1}).
    Starts from ``state["h"]`` where given."""
    out, h_final, xbc = _ssm_core(cfg, p, x, state.get("h"))
    w = cfg.ssm_conv - 1
    s = x.shape[1]
    tail = xbc[:, s - w:] if s >= w else F.pad(xbc, (0, 0, w - s, 0))
    return out, {"h": h_final, "conv": tail}


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cuda") -> dict:
    device = model_device(device)
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state),
                            dtype=PARAM_DTYPE, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p: SSM, x: torch.Tensor, state: dict):
    """One-token decode: x [B, 1, D] -> (y [B, 1, D], new state).  The conv
    window is the previous conv - 1 inputs followed by the current one."""
    bsz = x.shape[0]
    di, n, h, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, x[:, 0] @ shd.weight(p, "w_in"))
    window = torch.cat([state["conv"], xbc[:, None]], 1)  # [B,conv,C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(), p.conv_w.float())
    xbc_act = F.silu(conv_out + p.conv_b.float()).to(x.dtype)
    xs = xbc_act[..., :di].reshape(bsz, h, hd).float()
    b_in, c_in = xbc_act[..., di:di + n].float(), xbc_act[..., di + n:].float()
    dt_sp = F.softplus(dt.float() + p.dt_bias)  # [B,H]
    decay = torch.exp(dt_sp * -torch.exp(p.a_log))
    h_new = decay[:, :, None, None] * state["h"] + torch.einsum("bh,bn,bhd->bhdn", dt_sp, b_in, xs)
    y = torch.einsum("bn,bhdn->bhd", c_in, h_new) + xs * p.d_skip[None, :, None]
    y = rms_norm(y.reshape(bsz, di).to(x.dtype) * F.silu(z), p.norm, cfg.norm_eps)
    return (y @ shd.weight(p, "w_out"))[:, None], {"h": h_new, "conv": window[:, 1:]}
