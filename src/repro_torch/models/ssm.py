"""Mamba2 SSD block: the chunked dual form (prefill) and the recurrent step
(decode), function for function as the JAX package's models/ssm.py.

Per chunk of length Q the dual form computes
  intra-chunk:  Y_diag = ((C B^T) o L) (x dt)    -- kernels/ssd `ssd_chunk`
  chunk states: S_c    = B^T (decay o (x dt))     -- the same call
  inter-chunk:  a recurrence over the chunk states (a loop over chunks)
  state read:   Y_off  = C S_prev decay
The JAX model computes the first two with `einsum` and trains through
them by autodiff; here they are one call to `ssd_chunk`, which launches the
hand-written kernel on a CUDA tensor and runs its plain version (the JAX
kernel's oracle) on the CPU, and whose gradient (under autograd) is the
hand-written backward kernel `csrc/ssd_chunk_bwd.cu` (its plain version on
the CPU).  So `lm_loss` trains mamba2 and zamba2 on the card.  Both
keep f32 inside and round only Y_diag and S, where the JAX model rounds
C B^T, C B^T o L and the decay to the compute dtype before its products:
the same function, identical at f32, a few bf16 roundings apart at bf16
(ROADMAP, queue 3).  B and C reach the kernel as views expanded over the
heads of a group (the JAX model materialises `jnp.repeat`).

Everything else is plain PyTorch, as it is XLA outside any kernel in the
JAX package: the projections (through `linear`, so the tile GEMM under a
kernel `linear_impl`), the depthwise causal conv (JAX's shifted sum, not
`F.conv1d`, which cuDNN runs in TF32 for f32), the exact softplus
(`logaddexp(x, 0)`, as `jax.nn.softplus`), the inter-chunk recurrence (a
sequential loop where JAX runs an associative scan: the same recurrence,
summed in another order, over a list of the per-chunk states stacked once,
so autograd sees no in-place write), Y_off, the gated norm and the decode
step.

Under tensor parallelism (`parallel/sharding.py`, JAX's spec rules) a
rank holds nh / model heads: in_z / in_x, conv_x / conv_bx, A_log / D /
dt_bias and the gated norm's gain are column-sharded, out_proj is
row-parallel and ends in `reduce_from_tp`.  in_B, in_C, in_dt and the B /
C convs are replicated: each rank computes them whole from the replicated
input and takes its own heads' columns of dt and its own groups of B / C
(`_rank_groups`).  The gated norm's mean square runs over the whole
d_inner, so its (b, s) statistic is summed over `model` (`sum_over_tp`).
The cache follows JAX's `cache_specs`: the state and conv_x tail are the
rank's heads and channels, the conv_B / conv_C tails whole.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd.ops import ssd_chunk
from ..parallel import sharding as sh
from .layers import dense_init, norm_init
from .linear import linear


def _dims(cfg: ModelConfig, whole: bool = False):
    """(d_inner, N, P, heads, groups) of this rank: d_inner and the heads
    over `model`, the groups a rank's heads span (`_rank_groups`); with
    `whole`, the model's."""
    t = 1 if whole else sh.tp_size()
    di = cfg.ssm_d_inner // t
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    nh = di // P
    g = cfg.ssm_ngroups
    return di, N, P, nh, max(g // t, 1)


def _rank_groups(v, cfg: ModelConfig):
    """This rank's groups of a replicated (..., groups * N) B or C: its
    block where the groups split over `model`, else the one group its
    heads lie in.  Either way its gradient is summed over `model`."""
    t, g, N = sh.tp_size(), cfg.ssm_ngroups, cfg.ssm_state
    if g % t == 0:
        return sh.scatter_to_tp(v, -1)
    gi = sh.tp_rank() * g // t
    return sh.copy_to_tp(v)[..., gi * N:(gi + 1) * N]


def _gated_norm(p, y, z):
    """RMSNorm(y * silu(z)) over d_inner, `norm_apply`'s arithmetic: the
    mean square is the mean of the ranks' equal column blocks' means,
    summed over `model` (one rank: its own mean)."""
    v = y * F.silu(z)
    vf = v.float()
    ms = sh.sum_over_tp(vf.square().mean(dim=-1, keepdim=True)) / sh.tp_size()
    return (vf * torch.rsqrt(ms + 1e-5) * p["scale"]).to(v.dtype)


def init_ssm(gen: Optional[torch.Generator], cfg: ModelConfig, *, lead=(), device=None,
             dtype=torch.float32):
    """The JAX package's shapes and scales.  The six projections come out in
    `dtype`; the conv kernels and biases, A_log, D, dt_bias and the gated
    norm's gain stay float32, as JAX keeps them (it casts the conv kernels
    and D per use, and adds dt_bias in float32)."""
    h = cfg.d_model
    di, N, P, nh, g = _dims(cfg, whole=True)
    kw = dict(lead=lead, device=device, dtype=dtype)

    def normal(cols, scale):
        return torch.randn((*lead, cfg.conv_width, cols), generator=gen, device=device) * scale

    def const(values):
        return values.to(device).expand(*lead, nh).clone()

    return {
        "in_z": dense_init(gen, h, di, **kw),
        "in_x": dense_init(gen, h, di, **kw),
        "in_B": dense_init(gen, h, g * N, **kw),
        "in_C": dense_init(gen, h, g * N, **kw),
        "in_dt": dense_init(gen, h, nh, **kw),
        "conv_x": normal(di, 0.1),
        "conv_B": normal(g * N, 0.1),
        "conv_C": normal(g * N, 0.1),
        "conv_bx": torch.zeros((*lead, di), device=device),
        "conv_bB": torch.zeros((*lead, g * N), device=device),
        "conv_bC": torch.zeros((*lead, g * N), device=device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": const(torch.ones(nh)),
        "dt_bias": const(torch.zeros(nh)),
        "norm": norm_init(di, lead=lead, device=device),
        "out_proj": dense_init(gen, di, h, scale=1.0 / (2 * cfg.num_layers) ** 0.5, **kw),
    }


def _softplus(x):
    """log(1 + e^x), exact for every x (`jax.nn.softplus`): F.softplus
    returns x itself above its threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b):
    """Depthwise causal conv + SiLU.  x: (b, s, c); w: (k, c).  The JAX
    package's shifted sum, term by term in its order."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b.to(out.dtype))


def apply_ssm(p, x, cfg: ModelConfig, *, state=None):
    """Chunked SSD forward.  x: (b, s, h); the sequence is padded to a
    multiple of the chunk Q = min(ssm_chunk, s), the padded steps with
    dt = 0 (unit decay, zero input).  Returns (y, (final_state,
    conv_tails)) for the prefill -> decode handoff."""
    b, s, h = x.shape
    di, N, P, nh, g = _dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    dtype = x.dtype
    impl = cfg.linear_impl

    xc = sh.copy_to_tp(x)                              # into the column-parallel pair
    z = linear(xc, p["in_z"], impl=impl)
    u_x = linear(xc, p["in_x"], impl=impl)
    u_B = linear(x, p["in_B"], impl=impl)              # replicated: whole on every rank
    u_C = linear(x, p["in_C"], impl=impl)
    xr = _causal_conv(u_x, p["conv_x"].to(dtype), p["conv_bx"])
    Bv = _rank_groups(_causal_conv(u_B, p["conv_B"].to(dtype), p["conv_bB"]), cfg)
    Cv = _rank_groups(_causal_conv(u_C, p["conv_C"].to(dtype), p["conv_bC"]), cfg)
    dt = sh.scatter_to_tp(linear(x, p["in_dt"], impl=impl), -1)    # this rank's heads

    # conv-state tails for the handoff: the last (width - 1) pre-activation rows
    w1 = cfg.conv_width - 1

    def _tail(u):
        return u[:, s - w1:s] if s >= w1 else F.pad(u, (0, 0, w1 - s, 0))

    conv_tails = {"conv_x": _tail(u_x), "conv_B": _tail(u_B), "conv_C": _tail(u_C)}

    xin = xr.reshape(b, s, nh, P)
    dt = _softplus(dt.float() + p["dt_bias"])          # (b, s, nh) f32
    pad = -s % Q
    if pad:
        xin = F.pad(xin, (0, 0, 0, 0, 0, pad))
        Bv = F.pad(Bv, (0, 0, 0, pad))
        Cv = F.pad(Cv, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    sp = s + pad
    nc, hg = sp // Q, nh // g

    A = -torch.exp(p["A_log"])
    dA = (dt * A).reshape(b, nc, Q, nh)                # f32
    seg = torch.cumsum(dA, dim=2)
    x_dt = xin * dt.to(dtype)[..., None]               # (b, sp, nh, P)

    # the kernel's views, leading dims (b, groups, heads per group): no copy
    def heads(t):                                      # (b, nc, Q, g, hg, ...) -> lead first
        return t.permute(0, 3, 4, 1, 2, *range(5, t.dim()))

    def per_group(t):                                  # (b, sp, g*N) -> expanded over hg
        return heads(t.reshape(b, nc, Q, g, 1, N).expand(b, nc, Q, g, hg, N))

    y_diag, S = ssd_chunk(heads(x_dt.reshape(b, nc, Q, g, hg, P)), per_group(Bv),
                          per_group(Cv), heads(seg.reshape(b, nc, Q, g, hg)))
    y_diag = y_diag.permute(0, 3, 4, 1, 2, 5).reshape(b, sp, nh, P)
    S = S.reshape(b, nh, nc, N, P)

    # inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(dA.sum(dim=2)).to(dtype)   # (b, nc, nh)
    run = torch.zeros((b, nh, N, P), dtype=dtype, device=x.device) if state is None \
        else state.to(dtype)
    prev = []
    for c in range(nc):
        prev.append(run)
        run = S[:, :, c] + chunk_decay[:, c, :, None, None] * run
    S_prev = torch.stack(prev, 1)                      # (b, nc, nh, N, P)

    y_off = torch.einsum("bcqgn,bcghnp->bcqghp", Cv.reshape(b, nc, Q, g, N),
                         S_prev.reshape(b, nc, g, hg, N, P))
    y_off = y_off * torch.exp(seg).to(dtype).reshape(b, nc, Q, g, hg, 1)

    y = y_diag + y_off.reshape(b, sp, nh, P)
    y = y + xin * p["D"].to(dtype)[None, None, :, None]
    y = y.reshape(b, sp, di)[:, :s]
    y = _gated_norm(p["norm"], y, z)
    return sh.reduce_from_tp(linear(y, p["out_proj"], impl=impl, row=True)), (run, conv_tails)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None, *,
                   lead=()):
    """Zeros: the SSM state (b, nh, N, P) and each conv branch's tail (b,
    width - 1, channels), with `lead` dims in front (the stacked layers).
    Real zeros, one buffer per layer: the caches are written in place.
    Under tensor parallelism: this rank's heads and x channels, B and C
    whole."""
    di, N, P, nh, _ = _dims(cfg)
    g = cfg.ssm_ngroups
    w = cfg.conv_width - 1
    shapes = {"state": (batch, nh, N, P), "conv_x": (batch, w, di),
              "conv_B": (batch, w, g * N), "conv_C": (batch, w, g * N)}
    return {k: torch.zeros((*lead, *shp), dtype=dtype, device=device)
            for k, shp in shapes.items()}


def _conv_step(buf, new, w, b):
    """One causal-conv step.  buf: (b, k-1, c); new: (b, c)."""
    full = torch.cat([buf, new[:, None]], 1)
    out = F.silu(torch.einsum("bkc,kc->bc", full, w) + b.to(new.dtype))
    return out, full[:, 1:]


def decode_ssm(p, x, cfg: ModelConfig, cache):
    """Single-token recurrent step.  x: (b, 1, h).  Returns (y (b, 1, h),
    the new cache leaves)."""
    b = x.shape[0]
    di, N, P, nh, g = _dims(cfg)
    dtype = x.dtype
    xt = x[:, 0]
    impl = cfg.linear_impl
    xc = sh.copy_to_tp(xt)
    z = linear(xc, p["in_z"], impl=impl)
    xr, ncx = _conv_step(cache["conv_x"].to(dtype), linear(xc, p["in_x"], impl=impl),
                         p["conv_x"].to(dtype), p["conv_bx"])
    Bv, ncB = _conv_step(cache["conv_B"].to(dtype), linear(xt, p["in_B"], impl=impl),
                         p["conv_B"].to(dtype), p["conv_bB"])
    Cv, ncC = _conv_step(cache["conv_C"].to(dtype), linear(xt, p["in_C"], impl=impl),
                         p["conv_C"].to(dtype), p["conv_bC"])
    Bv, Cv = _rank_groups(Bv, cfg), _rank_groups(Cv, cfg)
    dt = sh.scatter_to_tp(linear(xt, p["in_dt"], impl=impl), -1)

    xin = xr.reshape(b, nh, P)
    Bh = Bv.reshape(b, g, 1, N).expand(b, g, nh // g, N).reshape(b, nh, N)
    Ch = Cv.reshape(b, g, 1, N).expand(b, g, nh // g, N).reshape(b, nh, N)

    dt = _softplus(dt.float() + p["dt_bias"])          # (b, nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A).to(dtype)
    x_dt = xin * dt.to(dtype)[..., None]

    state = cache["state"].to(dtype)
    state = state * dA[..., None, None] + torch.einsum("bhn,bhp->bhnp", Bh, x_dt)
    y = torch.einsum("bhnp,bhn->bhp", state, Ch) + xin * p["D"].to(dtype)[None, :, None]
    y = y.reshape(b, di)
    y = _gated_norm(p["norm"], y, z)
    out = sh.reduce_from_tp(linear(y, p["out_proj"], impl=impl, row=True))[:, None]
    return out, {"state": state, "conv_x": ncx, "conv_B": ncB, "conv_C": ncC}
