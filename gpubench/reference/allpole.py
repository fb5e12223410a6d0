"""All-pole recursions in float64, plain PyTorch, for the reference model.

``y[t] = x[t] - sum_{k=1..p} a[t, k-1] y[t-k]`` over rows, from a zero
state. Rows are cut into chunks: every chunk runs the recursion from a zero
state together with the responses to the p unit initial states (an
augmented state of p + 1 columns), the chunks' end states are then carried
through the chunks in order, and each chunk's output takes its incoming
state's response. All of it is float64, so the result is the float64
recursion to rounding; a row of at most one chunk runs the recursion alone.

The adjoint of the time-varying filter: lam[t] = g[t] - sum_k a[t+k, k-1]
lam[t+k], the same recursion run backwards in time on coefficients shifted
by their delay, and da[t, k-1] = -lam[t] y[t-k].
"""

from __future__ import annotations

import torch

CHUNK = 512


def scan(x: torch.Tensor, a: torch.Tensor, chunk: int = CHUNK
         ) -> torch.Tensor:
    """x (R, T), a (R, T, p) or (R, 1, p) for coefficients constant along
    a row; float64 in and out."""
    r, t = x.shape
    p = a.shape[-1]
    const = a.shape[1] == 1
    if t <= chunk:
        state = x.new_zeros((r, p))
        ys = []
        for i in range(t):
            ai = a[:, 0] if const else a[:, i]
            y = x[:, i] - (ai * state).sum(-1)
            ys.append(y)
            state = torch.cat([y[:, None], state[:, :-1]], dim=1)
        return torch.stack(ys, dim=1)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    xc = torch.nn.functional.pad(x, (0, pad)).reshape(r * nc, chunk)
    if const:
        ac = a.expand(r, nc, p).reshape(r * nc, 1, p)
    else:
        ac = torch.nn.functional.pad(a, (0, 0, 0, pad)).reshape(
            r * nc, chunk, p)
    # state rows: y[t-1] ... y[t-p]; column 0 from x, columns 1.. from e_j
    state = torch.cat([x.new_zeros((r * nc, p, 1)),
                       torch.eye(p, dtype=x.dtype, device=x.device)
                       .expand(r * nc, p, p)], dim=2)
    out = []
    for i in range(chunk):
        ai = ac[:, 0] if const else ac[:, i]
        y = -torch.einsum("rk,rkc->rc", ai, state)
        y[:, 0] += xc[:, i]
        out.append(y)
        state = torch.cat([y[:, None], state[:, :-1]], dim=1)
    resp = torch.stack(out, dim=1).reshape(r, nc, chunk, p + 1)
    ends = state.reshape(r, nc, p, p + 1)
    carry = x.new_zeros((r, p))
    incoming = []
    for c in range(nc):
        incoming.append(carry)
        carry = ends[:, c, :, 0] + torch.einsum(
            "rij,rj->ri", ends[:, c, :, 1:], carry)
    s0 = torch.stack(incoming, dim=1)                      # (r, nc, p)
    y = resp[..., 0] + torch.einsum("rclj,rcj->rcl", resp[..., 1:], s0)
    return y.reshape(r, nc * chunk)[:, :t]


def delayed(y: torch.Tensor, p: int) -> torch.Tensor:
    """d[:, t, k-1] = y[:, t-k], zero before the start: (R, T) -> (R, T,
    p)."""
    t = y.shape[1]
    cols = [torch.nn.functional.pad(y, (k, 0))[:, :t] for k in range(1, p + 1)]
    return torch.stack(cols, dim=-1)


class TimeVarying(torch.autograd.Function):
    """Time-varying all-pole of float32 x (B, T), a (B, T, p): float64
    inside, float32 out."""

    @staticmethod
    def forward(ctx, x, a):
        a64 = a.double()
        y = scan(x.double(), a64)
        ctx.save_for_backward(y, a)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        t, p = a.shape[1], a.shape[2]
        af = torch.flip(a.double(), (1,))
        # b[tau, k-1] = a[T-1-tau+k, k-1] = af[tau-k, k-1], zero for tau < k
        b = torch.stack([torch.nn.functional.pad(af[:, :, k - 1], (k, 0))
                         [:, :t] for k in range(1, p + 1)], dim=-1)
        lam = torch.flip(scan(torch.flip(g.double(), (1,)), b), (1,))
        da = -lam[..., None] * delayed(y, p)
        return lam.to(g.dtype), da.to(a.dtype)


class Constant(torch.autograd.Function):
    """All-pole with one coefficient vector a row: float32 x (N, T),
    a (N, p); float64 inside, float32 out."""

    @staticmethod
    def forward(ctx, x, a):
        y = scan(x.double(), a.double()[:, None], chunk=x.shape[1])
        ctx.save_for_backward(y, a)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        y, a = ctx.saved_tensors
        lam = torch.flip(scan(torch.flip(g.double(), (1,)),
                              a.double()[:, None], chunk=g.shape[1]), (1,))
        p = a.shape[-1]
        t = y.shape[1]
        da = -torch.stack([(lam[:, k:] * y[:, :t - k]).sum(1)
                           for k in range(1, p + 1)], dim=-1)
        return lam.to(g.dtype), da.to(a.dtype)
