"""Symmetric eigendecomposition of a small matrix by cyclic Jacobi sweeps.

`torch.linalg.eigh` on a CUDA tensor reads its error code back to the host
after every call, so it waits for all queued work and cannot run inside a
CUDA graph. This solver is plain tensor arithmetic: a fixed number of sweeps
in float64, each sweep n - 1 rounds of n / 2 disjoint plane rotations in the
round-robin order, one round applied as one orthogonal matrix G (A <- G^T A
G, V <- V G). Jacobi converges quadratically, so 6 sweeps leave the
off-diagonal of a 6x6 matrix at float64 rounding (the 6x6 scan-to-map
normal equations, whose eigenvalues span ~1e-3 to ~1e7).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounds(n: int):
    """Round-robin pairings of n (even) indices: n - 1 rounds of n / 2
    disjoint pairs (p, q), p < q, covering every pair once."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(tuple(tuple(sorted((players[i], players[n - 1 - i]))) for i in range(n // 2)))
        players = [players[0], players[-1], *players[1:-1]]
    return tuple(rounds)


def jacobi_eigh(A, sweeps: int = 6):
    """(n, n) symmetric, n even -> (evals (n,) ascending, evecs (n, n) with
    evecs[:, k] the k-th eigenvector), in A's dtype, like
    `torch.linalg.eigh`; computed in float64 with no read-back."""
    n = A.shape[-1]
    if A.dim() != 2 or n % 2:
        raise ValueError(f"jacobi_eigh takes one (n, n) matrix with n even, got {tuple(A.shape)}")
    a = A.to(torch.float64)
    v = torch.eye(n, dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for _ in range(sweeps):
        for pairs in _rounds(n):
            app = torch.stack([a[p, p] for p, _ in pairs])
            aqq = torch.stack([a[q, q] for _, q in pairs])
            apq = torch.stack([a[p, q] for p, q in pairs])
            # tan of the angle that zeroes a_pq: t = sgn(th) / (|th| + sqrt(th^2 + 1)),
            # th = (a_qq - a_pp) / (2 a_pq); no rotation where a_pq is already 0
            live = apq != 0
            th = (aqq - app) / (2.0 * torch.where(live, apq, one))
            t = torch.where(th >= 0, one, -one) / (th.abs() + torch.sqrt(th * th + 1.0))
            t = torch.where(live, t, zero)
            c = torch.rsqrt(t * t + 1.0)
            s = t * c
            entries = {}
            for k, (p, q) in enumerate(pairs):
                entries[(p, p)] = entries[(q, q)] = c[k]
                entries[(p, q)] = s[k]
                entries[(q, p)] = -s[k]
            G = torch.stack([entries.get((i, j), one if i == j else zero) for i in range(n) for j in range(n)])
            G = G.reshape(n, n)
            a = G.T @ a @ G
            v = v @ G
    evals, order = torch.sort(torch.diagonal(a))
    return evals.to(A.dtype), v[:, order].to(A.dtype)
