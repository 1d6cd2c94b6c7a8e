"""Closed-form batched 3x3 symmetric eigendecomposition (port of
`lego_loam_tpu/math/linalg3.py`).

Analytic eigenvalues from the characteristic cubic and eigenvectors from
products of shifted matrices, kept as (...,) component planes: every line
and plane fit runs this on thousands of tiny matrices at once.

Returns (evals ascending, evecs as columns), like `torch.linalg.eigh`.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvals3x3_components(a00, a01, a02, a11, a12, a22):
    """Eigenvalues from the six unique components, ascending tuple of (...,)."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    b00 = (a00 - q) / p
    b11 = (a11 - q) / p
    b22 = (a22 - q) / p
    b01 = a01 / p
    b02 = a02 / p
    b12 = a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    # near-diagonal / repeated-eigenvalue guard (component-wise 3-sort)
    d_lo = torch.minimum(torch.minimum(a00, a11), a22)
    d_hi = torch.maximum(torch.maximum(a00, a11), a22)
    d_mid = a00 + a11 + a22 - d_lo - d_hi
    near = p2 <= _EPS
    return (
        torch.where(near, d_lo, e_lo),
        torch.where(near, d_mid, e_mid),
        torch.where(near, d_hi, e_hi),
    )


def eigvec_extreme_components(comps, lam_a, lam_b):
    """Unit eigenvector for the eigenvalue of A not in (lam_a, lam_b): the
    largest-norm column of (A - lam_a I)(A - lam_b I)."""
    a00, a01, a02, a11, a12, a22 = comps
    b00, b11, b22 = a00 - lam_a, a11 - lam_a, a22 - lam_a
    c00, c11, c22 = a00 - lam_b, a11 - lam_b, a22 - lam_b
    m00 = b00 * c00 + a01 * a01 + a02 * a02
    m10 = a01 * c00 + b11 * a01 + a12 * a02
    m20 = a02 * c00 + a12 * a01 + b22 * a02
    m01 = b00 * a01 + a01 * c11 + a02 * a12
    m11 = a01 * a01 + b11 * c11 + a12 * a12
    m21 = a02 * a01 + a12 * c11 + b22 * a12
    m02 = b00 * a02 + a01 * a12 + a02 * c22
    m12 = a01 * a02 + b11 * a12 + a12 * c22
    m22 = a02 * a02 + a12 * a12 + b22 * c22

    n0 = m00 * m00 + m10 * m10 + m20 * m20
    n1 = m01 * m01 + m11 * m11 + m21 * m21
    n2 = m02 * m02 + m12 * m12 + m22 * m22

    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 > n0) & (n2 > n1) & ~use1
    vx = torch.where(use2, m02, torch.where(use1, m01, m00))
    vy = torch.where(use2, m12, torch.where(use1, m11, m10))
    vz = torch.where(use2, m22, torch.where(use1, m21, m20))
    nn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = nn > 1e-9
    inv = torch.where(ok, 1.0 / torch.clamp(nn, min=_EPS), torch.zeros_like(nn))
    return (
        torch.where(ok, vx * inv, torch.ones_like(vx)),
        torch.where(ok, vy * inv, torch.zeros_like(vy)),
        torch.where(ok, vz * inv, torch.zeros_like(vz)),
    )


def _components(A):
    return (
        A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2],
    )


def eigvals3x3_sym(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending (..., 3)."""
    return torch.stack(eigvals3x3_components(*_components(A)), dim=-1)


def eigh3x3(A):
    """(..., 3, 3) symmetric -> (evals (...,3) ascending, evecs (...,3,3)
    with evecs[..., :, k] the k-th eigenvector)."""
    comps = _components(A)
    lo, mid, hi = eigvals3x3_components(*comps)
    vlx, vly, vlz = eigvec_extreme_components(comps, mid, hi)
    vhx, vhy, vhz = eigvec_extreme_components(comps, lo, mid)
    # middle by orthogonality (keeps the frame consistent)
    vmx = vhy * vlz - vhz * vly
    vmy = vhz * vlx - vhx * vlz
    vmz = vhx * vly - vhy * vlx
    n = torch.sqrt(vmx * vmx + vmy * vmy + vmz * vmz)
    ok = n > 1e-9
    alt = eigvec_extreme_components(comps, lo, hi)
    inv = torch.where(ok, 1.0 / torch.clamp(n, min=_EPS), torch.zeros_like(n))
    vmx = torch.where(ok, vmx * inv, alt[0])
    vmy = torch.where(ok, vmy * inv, alt[1])
    vmz = torch.where(ok, vmz * inv, alt[2])
    evals = torch.stack([lo, mid, hi], dim=-1)
    evecs = torch.stack(
        [
            torch.stack([vlx, vmx, vhx], dim=-1),
            torch.stack([vly, vmy, vhy], dim=-1),
            torch.stack([vlz, vmz, vhz], dim=-1),
        ],
        dim=-2,
    )
    return evals, evecs
