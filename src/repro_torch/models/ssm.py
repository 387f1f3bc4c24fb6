"""Mamba2 (state-space duality) blocks: the chunked SSD train/prefill
path and the O(1)-state decode path, the reference's ``models/ssm.py``
op for op.

The minimal SSD formulation of Dao & Gu 2024 (arXiv:2405.21060), one
B/C group shared across heads:

  h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t (x)  (outer product)
  y_t = C_t . h_t + D_h * x_t

Training scans over chunks of length ``Q``: within a chunk the
recurrence is expanded into a (Q, Q) decay-masked quadratic form, and
across chunks only the (H, P, N) state is carried. The reference writes
the scan in plain jnp (no Pallas kernel), so it is plain PyTorch here:
``torch.einsum`` and a Python loop over the chunks.

Dtypes follow the reference: the projections, the gate ``z`` and the
causal conv run in the activation dtype (the conv's f32 weights cast to
it); ``B``, ``C``, ``dt``, the head-split ``x`` and the whole scan,
with its ``(B, H, P, N)`` state, run in f32.

Inside a model region (``repro_torch.parallel.hints.model_region``) the
training forward runs on this rank's heads, the reference's layout
(``parallel/sharding.py``): ``wx``, ``wz``, ``wdt`` are column shards
(``H/MP`` heads of ``head_dim``), ``A_log``, ``D_skip``, ``dt_bias``
this rank's heads' entries, ``wo`` a row shard summed over the axis;
``wB``, ``wC``, ``conv_w``, ``conv_b`` and the gated norm's scale are
replicated (see :func:`mamba_forward`). Prefill and decode run there
too (serving on the grid, ``serve/steps.py``): the ``ssm`` state holds
this rank's heads and the ``conv`` state all ``d_inner + 2N`` channels,
the same on every model rank (:func:`mamba_decode`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import hints
from .config import ModelConfig
from .layers import dense_init, init_rmsnorm, rmsnorm


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               lead: Tuple[int, ...] = ()):
    """One Mamba2 mixer's params (stacked on ``lead``), the reference's
    tree: the projections in the activation dtype, ``dt_bias``, ``A_log``
    (``log(linspace(1, 16, H))``), ``D_skip``, the conv and the gated
    norm in f32."""
    s = cfg.ssm
    D = cfg.d_model
    di, nh = s.d_inner(D), s.n_heads(D)
    dt, dev = cfg.activation_dtype, gen.device
    conv_ch = di + 2 * s.d_state
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                     device=dev))
    return {
        "wx": dense_init(gen, lead + (D, di), D, dt),
        "wz": dense_init(gen, lead + (D, di), D, dt),
        "wB": dense_init(gen, lead + (D, s.d_state), D, dt),
        "wC": dense_init(gen, lead + (D, s.d_state), D, dt),
        "wdt": dense_init(gen, lead + (D, nh), D, dt),
        "dt_bias": torch.zeros(lead + (nh,), dtype=torch.float32, device=dev),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D_skip": torch.ones(lead + (nh,), dtype=torch.float32, device=dev),
        "conv_w": dense_init(gen, lead + (s.d_conv, conv_ch), s.d_conv,
                             torch.float32),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=torch.float32,
                              device=dev),
        "norm": init_rmsnorm(di, lead, dev),
        "wo": dense_init(gen, lead + (di, D), di, dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold
    branch (torch's ``F.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv, window ``d_conv``. u: (B, S, C); w:
    (d_conv, C). With ``state`` (B, d_conv-1, C) the conv continues a
    stream (decode). Returns (silu(y) in ``u``'s dtype, new_state)."""
    dconv = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], dconv - 1, u.shape[-1]))
    ext = torch.cat([state, u], dim=1)                       # (B, S+dc-1, C)
    S = u.shape[1]
    y = sum(ext[:, i:i + S] * w[i] for i in range(dconv)) + b
    new_state = ext[:, -(dconv - 1):] if dconv > 1 else state
    return F.silu(y).to(u.dtype), new_state


def _pad_steps(a: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the last step of dim 1."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) if pad else a


def _ssd_chunk_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
                    Cm: torch.Tensor, chunk: int):
    """Chunked SSD. xdt: (B,S,H,P) = x*dt; dA: (B,S,H) = dt*A (negative);
    Bm, Cm: (B,S,N), all f32. Returns (y (B,S,H,P), final state
    (B,H,P,N)).

    ``Q = min(chunk, S)``; S is padded to whole chunks with ``dA = 0`` and
    ``xdt = 0``, so the carried state passes through the padded steps
    unchanged and the final state is the last real step's."""
    Bt, S, H, Pd = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    xdt, dA, Bm, Cm = (_pad_steps(a, pad) for a in (xdt, dA, Bm, Cm))
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    state = xdt.new_zeros((Bt, H, Pd, N))
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        x_c, dA_c, B_c, C_c = xdt[:, sl], dA[:, sl], Bm[:, sl], Cm[:, sl]
        cs = torch.cumsum(dA_c, dim=1)                        # (B,Q,H) inclusive
        total = cs[:, -1]                                     # (B,H)
        # intra-chunk decay exp(cs_i - cs_j) for i >= j. The *exponent* is
        # masked, not the product: i < j gives positive differences that
        # overflow exp and turn the backward through where() into NaN
        diff = cs[:, :, None, :] - cs[:, None, :, :]           # (B,Q,Q,H)
        diff = torch.where(causal[None, :, :, None], diff,
                           torch.full((), -1e30, dtype=diff.dtype,
                                      device=diff.device))
        dec = torch.exp(diff)
        scores = torch.einsum("bin,bjn->bij", C_c, B_c)
        M = scores[..., None] * dec
        y_diag = torch.einsum("bijh,bjhp->bihp", M, x_c)
        # the carried state's contribution
        y_off = torch.einsum("bin,bhpn->bihp", C_c, state) \
            * torch.exp(cs)[..., None]
        # state update: each step decayed to the chunk's end
        w_in = torch.exp(total[:, None, :] - cs)               # (B,Q,H)
        state = state * torch.exp(total)[:, :, None, None] \
            + torch.einsum("bjn,bjhp,bjh->bhpn", B_c, x_c, w_in)
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    return y[:, :S], state


def _project(x: torch.Tensor, p, cfg: ModelConfig, conv_state=None):
    """The mixer's input side, shared by forward and decode: the
    projections, ``dt`` (f32 softplus), the causal conv over
    ``[x, B, C]``. Returns (xh (B,S,H,P) f32, z, Bm, Cm f32, dt f32,
    conv_state). On a head shard (:func:`_head_shard`'s ``p``) ``x``'s
    channels and the heads are this rank's."""
    s = cfg.ssm
    B, S, D = x.shape
    xz = x @ p["wx"]                                  # (B,S,di)
    di = xz.shape[-1]
    z = x @ p["wz"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt = softplus((x @ p["wdt"]).to(torch.float32) + p["dt_bias"])
    conv_in = torch.cat([xz, Bm.to(xz.dtype), Cm.to(xz.dtype)], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"].to(xz.dtype), p["conv_b"].to(xz.dtype),
        None if conv_state is None else conv_state.to(xz.dtype))
    xz = conv_out[..., :di]
    Bm = conv_out[..., di:di + s.d_state].to(torch.float32)
    Cm = conv_out[..., di + s.d_state:].to(torch.float32)
    xh = xz.reshape(B, S, -1, s.head_dim).to(torch.float32)
    return xh, z, Bm, Cm, dt, conv_state


def _gate_out(y: torch.Tensor, z: torch.Tensor, x: torch.Tensor, p,
              cfg: ModelConfig) -> torch.Tensor:
    """(B,S,H,P) f32 -> the gated norm ``rmsnorm(y * silu(z))`` of width
    ``d_inner`` in ``x``'s dtype, then the out projection."""
    B, S, _ = x.shape
    y = y.reshape(B, S, -1).to(x.dtype)
    if hints.model_group() is None:
        return rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps) @ p["wo"]
    # the norm's mean runs over the whole d_inner: each row's sum of
    # squares summed over the shards, its gradient summed back
    yf = (y * F.silu(z)).to(torch.float32)
    ss = hints.sum_over_model(yf.square().sum(dim=-1, keepdim=True))
    var = ss / cfg.ssm.d_inner(cfg.d_model)
    y = (yf * torch.rsqrt(var + cfg.norm_eps) * p["norm"]["scale"]).to(x.dtype)
    return hints.reduce_from_model(y @ p["wo"])


def _head_shard(p, cfg: ModelConfig):
    """``p`` (this rank's shards) as :func:`_project` and :func:`_gate_out`
    take it on a head shard: the replicated leaves through
    ``copy_to_model`` (each rank's gradient of them is partial: its own
    heads' share, summed over the axis in one all-reduce a dtype), and
    ``conv_w`` / ``conv_b`` / the norm's scale cut to this rank's ``x``
    channels ``[t·di/MP, (t+1)·di/MP)`` (the conv) plus the ``2N``
    columns of ``B`` and ``C`` at ``di``."""
    di = cfg.ssm.d_inner(cfg.d_model)
    n = p["wx"].shape[-1]
    lo = hints.model_index() * n
    wB, wC, cw, cb, scale = hints.copy_to_model(
        p["wB"], p["wC"], p["conv_w"], p["conv_b"], p["norm"]["scale"])
    return {**p, "wB": wB, "wC": wC,
            "conv_w": torch.cat([cw[..., lo:lo + n], cw[..., di:]], dim=-1),
            "conv_b": torch.cat([cb[..., lo:lo + n], cb[..., di:]], dim=-1),
            "norm": {"scale": scale[..., lo:lo + n]}}


def mamba_forward(x: torch.Tensor, p, cfg: ModelConfig,
                  return_state: bool = False):
    """Train/prefill forward. x: (B, S, D) -> (B, S, D), and with
    ``return_state`` the decode state ``{"ssm": (B,H,P,N) f32, "conv":
    (B, d_conv-1, C) f32}`` after the last step.

    In a model region, on this rank's heads: ``x`` enters through
    ``copy_to_model``, the replicated leaves as :func:`_head_shard` says;
    ``B`` and ``C`` (one group for all heads) are whole on every rank;
    the SSD scan runs on the local heads with no collective (the heads
    are independent); the gated RMSNorm takes its mean over the whole
    ``d_inner`` (``hints.sum_over_model``: a per-shard mean would be a
    group norm, another function); ``wo``'s partial product is summed by
    ``reduce_from_model``. The returned state holds this rank's heads'
    ``ssm`` and the whole ``conv`` state: its ``x`` channels gathered
    over the model axis (:func:`_whole_conv`)."""
    sharded = hints.model_group() is not None
    if sharded:
        x = hints.copy_to_model(x)
        p = _head_shard(p, cfg)
    xh, z, Bm, Cm, dt, conv_state = _project(x, p, cfg)
    if sharded and return_state:
        conv_state = _whole_conv(conv_state, p["wx"].shape[-1])
    A = -torch.exp(p["A_log"])                        # (H,) negative
    y, ssm_state = _ssd_chunk_scan(xh * dt[..., None], dt * A, Bm, Cm,
                                   cfg.ssm.chunk)
    y = y + xh * p["D_skip"][None, None, :, None]
    out = _gate_out(y, z, x, p, cfg)
    if return_state:
        return out, {"ssm": ssm_state, "conv": conv_state.to(torch.float32)}
    return out


def _whole_conv(conv: torch.Tensor, n: int) -> torch.Tensor:
    """A head shard's conv rows ``(B, d, n + 2N)`` (its ``n`` channels of
    ``x``, then ``B`` and ``C``) with all ``d_inner`` channels of ``x``:
    every model rank's gathered in rank order, the same bytes on every
    rank."""
    return torch.cat([hints.gather_from_model(conv[..., :n].contiguous()),
                      conv[..., n:]], dim=-1)


def init_mamba_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero decode state; in a model region the ``ssm`` state holds this
    rank's ``H/MP`` heads (the ``conv`` state stays whole)."""
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    group = hints.model_group()
    if group is not None:
        nh //= group.workers
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, s.d_conv - 1,
                             s.d_inner(cfg.d_model) + 2 * s.d_state),
                            dtype=dtype, device=device),
    }


def mamba_decode(x: torch.Tensor, p, cfg: ModelConfig, state):
    """Single-token decode. x: (B, 1, D); ``state`` as
    :func:`init_mamba_state`. Returns (y (B, 1, D), new state in the
    state's dtypes).

    In a model region on this rank's heads, as :func:`mamba_forward`:
    the conv runs on this rank's channels of the whole ``conv`` state,
    and the new state is the old one shifted by a row with the new input
    row appended, its ``x`` channels gathered over the model axis, so
    every model rank keeps the same whole state."""
    conv_in = state["conv"]
    sharded = hints.model_group() is not None
    if sharded:
        x = hints.copy_to_model(x)
        p = _head_shard(p, cfg)
        n = p["wx"].shape[-1]
        lo, di = hints.model_index() * n, cfg.ssm.d_inner(cfg.d_model)
        conv_in = torch.cat([conv_in[..., lo:lo + n], conv_in[..., di:]], dim=-1)
    xh, z, Bm, Cm, dt, conv_state = _project(x, p, cfg, conv_in)
    if sharded and conv_state.shape[1]:
        row = _whole_conv(conv_state[:, -1:], n).to(state["conv"].dtype)
        conv_state = torch.cat([state["conv"][:, 1:], row], dim=1)
    xh, Bm, Cm, dt0 = xh[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0]   # (B,H,P), (B,N), (B,H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt0 * A)                           # (B,H)
    h = state["ssm"] * dA[:, :, None, None] \
        + torch.einsum("bn,bhp,bh->bhpn", Bm, xh, dt0)
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + xh * p["D_skip"][None, :, None]
    return _gate_out(y[:, None], z, x, p, cfg), {
        "ssm": h.to(state["ssm"].dtype),
        "conv": conv_state.to(state["conv"].dtype)}
