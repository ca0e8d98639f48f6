"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060], a port of
``repro.models.ssm``.

The chunked SSD forward of training and prefill (an O(L·Q) intra-chunk
term, an O(L/Q) recurrence across chunks) and the O(1)-per-token recurrent
decode step.  The JAX package lowers all of it through XLA (no Pallas
kernel), and this module is plain PyTorch on either device: the recurrence
across chunks is a Python loop where the JAX package scans.

Dtypes follow the JAX function cast for cast: the projections and the
causal convolution run in the activation dtype (the conv's SiLU in f32),
``dt``, the decays and the scan in f32 (``A_log``, ``dt_bias``, ``D`` and
``gate_norm`` are f32 leaves), and the output is cast back to the
activation dtype before the gated norm.  Softplus is ``logaddexp(x, 0)``,
``jax.nn.softplus``'s form (``F.softplus`` returns x itself above 20).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rmsnorm, spec

CONV_K = 4  # depthwise causal conv width


def ssm_specs(cfg, layers):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = cfg.ssm_heads
    N = cfg.ssm_state
    # one projection per stream (z, x, BC, dt), the JAX package's layout
    return {
        "in_z": spec((layers, d, di), ("layers", "embed", "ff")),
        "in_x": spec((layers, d, di), ("layers", "embed", "ff")),
        "in_bc": spec((layers, d, 2 * N), ("layers", "embed", "ff")),
        "in_dt": spec((layers, d, H), ("layers", "embed", "heads")),
        "conv_x": spec((layers, CONV_K, di), ("layers", None, "ff"),
                       scale=0.5),
        "conv_bc": spec((layers, CONV_K, 2 * N), ("layers", None, "ff"),
                        scale=0.5),
        "A_log": spec((layers, H), ("layers", "heads"), scale=0.0,
                      dtype=torch.float32),
        "dt_bias": spec((layers, H), ("layers", "heads"), scale=0.0,
                        dtype=torch.float32),
        "D": spec((layers, H), ("layers", "heads"), scale=-1.0,
                  dtype=torch.float32),
        "gate_norm": spec((layers, di), ("layers", "ff"), scale=-1.0,
                          dtype=torch.float32),
        "out_proj": spec((layers, di, d), ("layers", "ff", "embed")),
    }


def _project(x, p):
    """The per-stream input projections (one device: no sharding
    constraints)."""
    return x @ p["in_z"], x @ p["in_x"], x @ p["in_bc"], x @ p["in_dt"]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u, w):
    """Depthwise causal conv, kernel CONV_K. u: (B,L,C); w: (K,C)."""
    L = u.shape[1]
    pads = [F.pad(u, (0, 0, CONV_K - 1 - i, 0))[:, :L] for i in range(CONV_K)]
    out = pads[0] * w[CONV_K - 1]
    for i in range(1, CONV_K):
        out = out + pads[i] * w[CONV_K - 1 - i]
    return F.silu(out.float()).to(u.dtype)


def _segsum(a):
    """a: (..., Q). Returns (..., Q, Q) with S[i,j] = sum_{j<m<=i} a[m] on the
    lower triangle, -inf above (``exp`` of it is 0, with a zero gradient)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_scan(xh, dt, A, Bm, Cm, chunk):
    """Chunked SSD. xh: (B,L,H,P); dt: (B,L,H) (post-softplus); A: (H,) (<0);
    Bm/Cm: (B,L,N) single group. Returns y: (B,L,H,P) and final state
    (B,H,P,N) in f32."""
    Bsz, L, H, Pd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0
    C_ = L // Q

    xc = xh.reshape(Bsz, C_, Q, H, Pd)
    dtc = dt.reshape(Bsz, C_, Q, H)
    Bc = Bm.reshape(Bsz, C_, Q, N)
    Cc = Cm.reshape(Bsz, C_, Q, N)

    a = dtc * A  # (B,C,Q,H) log-decay per step
    a_hqt = a.movedim(-1, 2)  # (B,C,H,Q)

    # intra-chunk (diagonal blocks): attention-like with decay kernel
    Lmat = torch.exp(_segsum(a_hqt))  # (B,C,H,Q,Q)
    dtx = xc * dtc[..., None]  # (B,C,Q,H,P)
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", cb[:, :, None] * Lmat, dtx)

    # chunk states: decay from position q to end of chunk = exp(sum_{m>q} a_m)
    cum = a_hqt.cumsum(dim=-1)
    a_sum = a_hqt.sum(dim=-1)  # (B,C,H)
    rev = torch.exp(a_sum[..., None] - cum)  # (B,C,H,Q)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          dtx * rev.movedim(2, 3)[..., None])  # (B,C,H,P,N)

    # inter-chunk recurrence (the JAX package's lax.scan)
    s = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=xh.device)
    states_f = states.float()
    prev = []
    for c in range(C_):
        prev.append(s)
        s = s * torch.exp(a_sum[:, c])[:, :, None, None] + states_f[:, c]
    prev_states = torch.stack(prev, 1)  # (B,C,H,P,N) state before chunk

    # off-diagonal: contribution of carried-in state
    decay_in = torch.exp(cum)  # decay from chunk start to q
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states.to(Cc.dtype))
             * decay_in.movedim(2, 3)[..., None])

    y = (y_diag + y_off).reshape(Bsz, L, H, Pd)
    return y, s


def mamba2_seq(x, p, cfg, return_state=False, *, whole_bc=None,
               gate_mean=None):
    """Full-sequence Mamba2 block. x: (B,L,d) -> (B,L,d); with
    ``return_state`` also the final SSM state (B,H,P,N) f32 and the last
    CONV_K-1 pre-conv inputs of each stream, the decode's conv windows.

    A rank of the partitioned train step passes ``p`` with its channels and
    heads (``in_z`` / ``in_x`` / ``conv_x`` / ``gate_norm`` / ``out_proj``
    on its channels, ``in_dt`` / ``A_log`` / ``dt_bias`` / ``D`` on its
    heads): the scan runs its heads, and the result is its channels'
    partial sum of ``out_proj``, the caller's to sum over the ranks.
    ``whole_bc`` takes the conv'd B / C columns its ``in_bc`` holds to all
    2N (the scan reads them whole); ``gate_mean`` takes the gated norm's
    mean of squares over its channels to the whole width's."""
    B, L, d = x.shape
    di, H = p["in_x"].shape[-1], p["A_log"].shape[-1]
    N = cfg.ssm_state
    Pd = di // H

    z, xi_pre, bc_pre, dt = _project(x, p)
    xi = _causal_conv(xi_pre, p["conv_x"])
    bc = _causal_conv(bc_pre, p["conv_bc"])
    if whole_bc is not None:
        bc = whole_bc(bc)
    Bm, Cm = bc[..., :N], bc[..., N:]

    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, L, H, Pd)

    # pad ragged L to a chunk multiple; zero dt ⇒ padded steps are identity
    Q = min(cfg.ssm_chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    y, state = ssd_scan(xh, dt, A, Bm.float(), Cm.float(), cfg.ssm_chunk)
    y = (y + xh.float() * p["D"][None, None, :, None])[:, :L]
    y = y.reshape(B, L, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"],
                across=gate_mean)
    out = y @ p["out_proj"]
    if return_state:
        conv_buf = (xi_pre[:, -(CONV_K - 1):], bc_pre[:, -(CONV_K - 1):])
        return out, state, conv_buf
    return out


def _conv_step(window, w, x_dtype):
    """One causal-conv output given the (B, K, C) rolling window.

    window[:, K-1-m] is the input m steps ago; the seq path weights the
    m-steps-ago input with w[m]."""
    out = window[:, CONV_K - 1] * w[0]
    for m in range(1, CONV_K):
        out = out + window[:, CONV_K - 1 - m] * w[m]
    return F.silu(out.float()).to(x_dtype)


def _window(buf, new):
    """The rolling window: the CONV_K-1 earlier inputs ``buf`` and this
    step's ``new`` (B, 1, C), in their promoted dtype."""
    dt = torch.promote_types(buf.dtype, new.dtype)
    return torch.cat([buf.to(dt), new.to(dt)], dim=1)


def mamba2_decode(x, p, cfg, state, conv_buf):
    """One-token recurrent step.

    x: (B,1,d); state: (B,H,P,N) f32; conv_buf: pair of rolling pre-conv
    windows ((B,CONV_K-1,di), (B,CONV_K-1,2N)).  Returns
    (out, new_state, new_conv_buf); the caller writes them into its cache.
    """
    B = x.shape[0]
    di = cfg.ssm_expand * cfg.d_model
    H, N = cfg.ssm_heads, cfg.ssm_state
    Pd = di // H

    z, xi_new, bc_new, dt = _project(x, p)
    buf_x, buf_bc = conv_buf
    win_x = _window(buf_x, xi_new)
    win_bc = _window(buf_bc, bc_new)
    xi = _conv_step(win_x, p["conv_x"], x.dtype)
    bc = _conv_step(win_bc, p["conv_bc"], x.dtype).float()
    Bm, Cm = bc[:, :N], bc[:, N:]

    dt = softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)  # (B,H)
    xh = xi.reshape(B, H, Pd).float()
    dBx = (dt[:, :, None] * xh)[..., None] * Bm[:, None, None, :]
    state = state * decay[:, :, None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, Cm) + xh * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"])
    return y @ p["out_proj"], state, (win_x[:, 1:], win_bc[:, 1:])
