"""Spectral Poisson projection (``pressure_solver="fft"``), the counterpart
of ``fluidsim_tpu/ops/fft_poisson.py``.

An exact projection for obstacle-free closed boxes.  The solver family's
divergence and gradient are central differences of spacing 2, so
``div∘grad`` is the wide Laplacian ``Σ_axis p(x±2) − 2p(x)`` over 4;
solving with its eigenvalues makes the projected field's central-difference
divergence vanish up to the operator's checkerboard null space.  No-flux
walls come from mirror extension to 2N per axis (the wall-normal component
odd, the rest even); the periodic solve on the extension restricts to the
Neumann solution, and the zero-eigenvalue modes are projected out.

The JAX package computes these FFTs with XLA outside any Pallas kernel, so
the port computes them with ``torch.fft`` in float32; the eigenvalue table
is computed on the host in float64 and rounded to float32, as there.

``project_3d_fft_shards`` is the same projection on the z-slabs of a mesh
(what XLA's partitioner makes of ``project_3d_fft`` on a sharded state), no
shard ever holding an N-deep volume: the divergence on each shard's planes,
the x and y transforms there, an all-to-all to z-pencils (each shard all N
planes of its ``2N/k`` rows of ky), the z mirror, transforms and the
eigenvalue rows on the pencil, an all-to-all back, the inverse x and y
transforms and the gradient on each shard's planes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.profiling import spanned


def _mirror(f, parities):
    """Extend to 2N per axis: ``[f, ±reverse(f)]`` with the given parity
    (+1 even, −1 odd) per axis."""
    for ax, s in enumerate(parities):
        f = torch.cat([f, s * torch.flip(f, dims=(ax,))], dim=ax)
    return f


def _crop(f, n: int):
    return f[tuple(slice(0, n) for _ in range(f.ndim))]


def _cdiff(f, axis: int):
    """Central difference ``(f(x+1) − f(x−1))/2``, periodic (valid on the
    mirror extension)."""
    return 0.5 * (torch.roll(f, -1, axis) - torch.roll(f, 1, axis))


def _wide_inv_eigenvalues(shape_ext, rfft_axis_len: int, rows=None) -> np.ndarray:
    """``1/eigenvalue`` of the wide Laplacian ``Σ p(x±2) − 2p`` on the
    periodic extension, 0 where the eigenvalue (numerically) vanishes;
    float32, computed in float64 as the JAX package computes it.  ``rows``
    (a ``slice`` of axis 1) gives those rows of the table alone, each value
    the whole table's."""
    dims = len(shape_ext)
    total = None
    for ax in range(dims):
        m = shape_ext[ax]
        if ax == dims - 1:
            freqs = np.arange(rfft_axis_len, dtype=np.float64) / m
        else:
            freqs = np.fft.fftfreq(m)
        if ax == 1 and rows is not None:
            freqs = freqs[rows]
        lam = 2.0 * np.cos(4.0 * np.pi * freqs) - 2.0
        bshape = [1] * dims
        bshape[ax] = len(freqs)
        lam = lam.reshape(bshape)
        total = lam if total is None else total + lam
    inv = np.where(np.abs(total) > 1e-8, 1.0 / np.where(total == 0, 1, total), 0.0)
    return inv.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _inv_table(shape_ext, rfft_axis_len: int, device: torch.device) -> torch.Tensor:
    """``_wide_inv_eigenvalues`` on ``device``, built once per grid (a
    constant of the step, as XLA folds it into the compiled program)."""
    return torch.from_numpy(_wide_inv_eigenvalues(shape_ext, rfft_axis_len)).to(device)


@functools.lru_cache(maxsize=64)
def _inv_rows(shape_ext, rfft_axis_len: int, lo: int, hi: int,
              device: torch.device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of axis 1 of ``_inv_table`` on ``device``: one
    shard's share of the table, built once per grid and shard, never the
    whole table."""
    return torch.from_numpy(_wide_inv_eigenvalues(shape_ext, rfft_axis_len,
                                                  slice(lo, hi))).to(device)


# The mirror parity of each component along the [z, y, x] axes: component c
# points along grid axis 2 − c and is odd across its own walls.
_PARITIES = {0: (1, 1, -1), 1: (1, -1, 1), 2: (-1, 1, 1)}


def project_3d_fft(vel: torch.Tensor):
    """Exact wide-operator projection of a ``(3, N, N, N)`` velocity
    (obstacle-free closed box), computed in float32.  Returns ``(vel, p)``
    in ``vel``'s dtype, ``p`` cropped to N³."""
    n = vel.shape[-1]
    dtype = vel.dtype
    ext = [_mirror(vel[c].to(torch.float32), _PARITIES[c]) for c in range(3)]
    div = _cdiff(ext[0], 2) + _cdiff(ext[1], 1) + _cdiff(ext[2], 0)

    # div∘grad = wide_lap/4  ⇒  wide_lap(p) = 4·div
    rhs_hat = torch.fft.rfftn(4.0 * div)
    inv = _inv_table(tuple(div.shape), rhs_hat.shape[-1], div.device)
    p_ext = torch.fft.irfftn(rhs_hat * inv, s=div.shape)

    out = [ext[0] - _cdiff(p_ext, 2), ext[1] - _cdiff(p_ext, 1), ext[2] - _cdiff(p_ext, 0)]
    return (torch.stack([_crop(o, n) for o in out]).to(dtype), _crop(p_ext, n).to(dtype))


def _edges(f, axis: int, sign: float):
    """``f`` between one plane of its mirror extension on each side along
    ``axis``: ``sign·`` its first and last planes (−1 for the component
    normal to that axis's walls, +1 else)."""
    lo, hi = f.narrow(axis, 0, 1), f.narrow(axis, f.shape[axis] - 1, 1)
    if sign < 0:
        lo, hi = -lo, -hi
    return torch.cat([lo, f, hi], dim=axis)


def _cdiff_padded(fp, axis: int):
    """``_cdiff`` on the planes of ``fp`` between its first and last along
    ``axis`` (a tensor padded by one plane each side)."""
    m = fp.shape[axis] - 2
    return 0.5 * (fp.narrow(axis, 2, m) - fp.narrow(axis, 0, m))


def project_3d_fft_shards(vels, order=None):
    """``project_3d_fft`` on the z-slabs of a mesh: ``vels`` holds each
    shard's ``(3, lz, N, N)`` velocity (rank order, plane 0 of shard r at
    global z ``r·lz``, each on its shard's device); returns each shard's
    ``(vel, p)`` slabs in the velocity's dtype.  ``order`` is the shards'
    ``parallel/streams.ShardOrder`` (by default the one of ``vels``' devices).

    No shard holds an N-deep volume or the 2N mirror of one:

    * the divergence of the mirror extension on the shard's planes: x and y
      mirrored locally, z from one halo plane of ``vz`` from each neighbour
      (``−vz`` of the shard's own edge plane past a global wall, ``vz``
      being odd in z); the same arithmetic as ``project_3d_fft``'s;
    * the divergence is even along every axis, so its x and y extension is
      the shard's mirror, and its z extension is made after the transpose:
      ``rfft`` along x and ``fft`` along y of the shard's ``(lz, 2N, 2N)``
      planes, an all-to-all that hands shard r all N planes of its ``2N/k``
      rows of ky, the z mirror, ``fft`` along z, the rows of the
      inverse-eigenvalue table (``_inv_rows``: the table's own values, one
      shard's rows cached on its device), ``ifft`` along z, N planes kept, an
      all-to-all back, ``ifft`` along y and ``irfft`` along x;
    * the gradient on the shard's planes, ``p`` even across every wall
      (``p[−1] = p[0]``, ``p[N] = p[N−1]``) and one halo plane of it from
      each neighbour.

    Each all-to-all is ordered as every cross-shard read: the shards' marks
    after their transforms, each shard's stream waiting on every shard's
    before it reads their blocks (held for its stream, copied across cards)
    into a buffer of its own.  Float32 throughout, as ``project_3d_fft``;
    the split transforms round differently from the whole-volume ones, so
    the result is not bitwise ``project_3d_fft``'s: the two differ by about
    the float32 error each has against a float64 projection, which grows
    with n (``tools/torch_fft_shards_accuracy.py`` measures both)."""
    from ..parallel.streams import order_of

    order = order or order_of(vels)
    k = len(vels)
    lz, n = vels[0].shape[1], vels[0].shape[-1]
    n2 = 2 * n
    if n2 % k:
        raise ValueError(f"2N = {n2} rows of ky do not split into {k} shards")
    rows = n2 // k
    dtype = vels[0].dtype
    with order.scope():
        v32 = order.each(lambda r: vels[r].to(torch.float32))
        vz = _z_halos([v[2] for v in v32], order, -1.0)

        def spectrum(r):
            v = v32[r]
            div = (_cdiff_padded(_edges(v[0], 2, -1.0), 2)
                   + _cdiff_padded(_edges(v[1], 1, -1.0), 1)) + _cdiff_padded(vz[r], 0)
            div = torch.cat([div, torch.flip(div, dims=(2,))], dim=2)
            div = torch.cat([div, torch.flip(div, dims=(1,))], dim=1)
            return torch.fft.fft(torch.fft.rfft(4.0 * div, dim=2), dim=1)

        spec = order.each(spectrum)
        # z-pencils: shard r's rows of ky, every z plane.
        pencils = _all_to_all(order, [[s.narrow(1, r * rows, rows) for r in range(k)]
                                      for s in spec], 0)
        del spec
        shape_ext = (n2, n2, n2)

        def solve(r):
            pz = pencils[r]
            pz = torch.fft.fft(torch.cat([pz, torch.flip(pz, dims=(0,))], dim=0), dim=0)
            inv = _inv_rows(shape_ext, n + 1, r * rows, (r + 1) * rows, pz.device)
            return torch.fft.ifft(pz * inv, dim=0)[:n]

        solved = order.each(solve)
        del pencils
        # Back to slabs: shard r's planes, every row of ky.
        slabs = _all_to_all(order, [[s.narrow(0, r * lz, lz) for r in range(k)]
                                    for s in solved], 1)
        del solved
        p = order.each(lambda r: torch.fft.irfft(torch.fft.ifft(slabs[r], dim=1), n=n2,
                                                 dim=2)[:, :n, :n].contiguous())
        del slabs
        ph = _z_halos(p, order, 1.0)

        def gradient(r):
            v = v32[r]
            out = torch.stack([v[0] - _cdiff_padded(_edges(p[r], 2, 1.0), 2),
                               v[1] - _cdiff_padded(_edges(p[r], 1, 1.0), 1),
                               v[2] - _cdiff_padded(ph[r], 0)])
            return out.to(dtype), p[r].to(dtype)

        return order.each(gradient)


@spanned("halo.exchange")
def _z_halos(xs, order, sign: float):
    """Each shard's ``(lz, N, N)`` slab of ``xs`` between the last plane of
    the shard below and the first of the shard above, past a global wall
    ``sign·`` its own edge plane (the mirror extension's plane there)."""
    k = len(xs)
    marks = order.marks()
    out = []
    for r in range(k):
        with order.on(r):
            order.wait(r, marks, r - 1, r + 1)
            below = order.fetch(xs[r - 1][-1:], r) if r > 0 else sign * xs[r][:1]
            above = order.fetch(xs[r + 1][:1], r) if r < k - 1 else sign * xs[r][-1:]
            out.append(torch.cat([below, xs[r], above]))
    return out


@spanned("halo.exchange")
def _all_to_all(order, blocks, axis: int):
    """``blocks[s][r]`` is shard s's block for shard r: each shard r gets
    ``blocks[·][r]`` joined along ``axis`` in rank order, in a buffer of its
    own made on its stream after it waited on every shard's mark."""
    k = len(blocks)
    marks = order.marks()
    out = []
    for r in range(k):
        with order.on(r):
            order.wait(r, marks, *range(k))
            out.append(torch.cat([order.fetch(blocks[s][r], r) for s in range(k)], dim=axis))
    return out
