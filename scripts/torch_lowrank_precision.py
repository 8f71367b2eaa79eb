#!/usr/bin/env python3
"""How far the lazy low-rank kernels' arithmetic lies from f64, emulated on
the CPU in torch (no card needed).

    python3 scripts/torch_lowrank_precision.py [--shape S P I J F] [--seed N]

On the Normal's factors with heavy cancellation (``tests/lowrank_operands.py``,
terms 1e2-1e4 times the score; default shape (1, 8, 1000, 300, 36), the
cancellation case of ``chip_smoke.py``) it prints the max abs error against
an f64 evaluation of out, dU, dV and dD for:

* ``plain``: the plain version under autograd (weights normalised by the
  sum of their exponentials);
* ``f64-scores``: the f64 scores plus D rounded to f32, with the weights
  g * exp(score + D - out), out rounded to f32;
* ``3xtf32``: the kernels' scores (TF32 hi/lo splits rounded to nearest,
  three products, each k step of 8 features summed afresh and added in f32)
  with the same weights;
* ``3xtf32+rnd``: the same with the rounding of out's last sum (TwoSum)
  taken out of every weight, as the kernels do.

The tensor cores round their sums toward zero, which the emulation does not,
so it bounds the card's figures from below.  One JSON line per variant.
"""
import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def scores_3xtf32(U, V):
    Uh, Vh = tf32(U), tf32(V)
    Ul, Vl = tf32(U - Uh), tf32(V - Vh)
    dot = lambda a, b: torch.einsum("spif,sjf->spij", a, b)
    acc = torch.zeros(U.shape[:3] + (V.shape[1],))
    for k in range(0, U.shape[-1], 8):
        f = slice(k, k + 8)
        acc = acc + ((dot(Uh[..., f], Vl[..., f]) + dot(Ul[..., f], Vh[..., f]))
                     + dot(Uh[..., f], Vh[..., f]))
    return acc


def lse_parts(A):
    """The kernels' logsumexp over i: shift, log of the sum, out = their f32
    sum and the rounding of that sum."""
    m = torch.amax(A, 2)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    a = torch.log(torch.exp(A - m[:, :, None]).sum(2) + torch.finfo(A.dtype).tiny)
    out = a + m
    ob = out - m
    return out, (a - ob) + (m - (out - ob))


def grads(w, U, V):
    """dU, dV, dD from the weights w[s,p,i,j], summed in f64."""
    w = w.double()
    return (torch.einsum("spij,sjf->spif", w, V.double()),
            torch.einsum("spij,spif->sjf", w, U.double()), w.sum(3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=5, default=[1, 8, 1000, 300, 36])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    from lowrank_operands import normal_factor_operands
    U, V, D, G = (torch.as_tensor(a) for a in normal_factor_operands(
        tuple(args.shape), args.seed, 1.0, 0.3, 3e-4))

    A64 = torch.einsum("spif,sjf->spij", U.double(), V.double()) + D.double()[..., None]
    out64, _ = lse_parts(A64)
    exact = (out64,) + grads(G.double()[:, :, None, :] * torch.exp(A64 - out64[:, :, None]),
                             U, V)

    def report(name, got):
        emit = {"variant": name, "shape": args.shape}
        for k, a, b in zip(("out", "dU", "dV", "dD"), got, exact):
            emit[k] = (a.double() - b).abs().max().item()
        print(json.dumps(emit), flush=True)

    ts = [t.clone().requires_grad_(True) for t in (U, V, D)]
    A = torch.einsum("spif,sjf->spij", ts[0], ts[1]) + ts[2][..., None]
    m = torch.amax(A, 2).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = torch.log(torch.exp(A - m[:, :, None]).sum(2) + torch.finfo(A.dtype).tiny) + m
    report("plain", (out.detach(),) + torch.autograd.grad(out, ts, G))

    A64r = A64.float()
    out64r, _ = lse_parts(A64r)
    w64r = G[:, :, None, :] * torch.exp(A64r - out64r[:, :, None])
    report("f64-scores", (out64r,) + grads(w64r, U, V))

    A3 = scores_3xtf32(U, V) + D[..., None]
    out3, rnd = lse_parts(A3)
    x = A3 - out3[:, :, None]
    report("3xtf32", (out3,) + grads(G[:, :, None, :] * torch.exp(x), U, V))
    report("3xtf32+rnd", (out3,) + grads(G[:, :, None, :] * torch.exp(x - rnd[:, :, None]),
                                          U, V))


if __name__ == "__main__":
    main()
