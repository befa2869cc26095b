#!/usr/bin/env python3
"""How far the FFT projection on z-pencils (``ops/fft_poisson.
project_3d_fft_shards``) lands from the whole-volume ``project_3d_fft``, and
how far each lands from the same projection in float64.

Run from the root of a checkout:
    python3 tools/torch_fft_shards_accuracy.py [--device cpu|cuda] [--n 128] [--shards 8]
                                               [--steps 3] [--no-f64] [--transforms]
                                               [--transforms-only]

On sharded512's config at ``n``³ with ``pressure_solver="fft"``, from
chip_smoke.py's seeded start (the same smooth fields at any n), prints one
JSON line:

* ``step``: the sharded step (``halo="auto"``, ``--shards`` shards) against
  the unsharded ``Engine`` on the same plain ops after ``--steps`` steps,
  per field the max abs difference over max|ref| and the part of it past
  rtol 1e-5 (``(|d| − 1e-5·|ref|)_max / max|ref|``: the sharded step's
  class asks for at most 1e-6);
* ``projection``: one projection of the start's velocity by both float32
  routes, each against the float64 projection (the same formula in
  float64), and against each other, as max abs over max |float64|; and
  max|p| / max|v|, which scales the velocity's share of the pressure's
  rounding (``--no-f64`` leaves the float64 projection out, where it does
  not fit);
* with ``--transforms``, ``transforms``: on a seeded (2N)³ float32 volume,
  each way of composing the forward 3D real transform from 1D and 2D ones
  (and the inverse) against ``rfftn`` (``irfftn``), whole, on ``--shards``
  slabs of planes and on as many blocks of x-frequency columns, as max abs
  over max and whether bitwise (``--transforms-only``: nothing else).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-f64", action="store_true")
    ap.add_argument("--transforms", action="store_true")
    ap.add_argument("--transforms-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.ops import fft_poisson as fp
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn, unshard_state
    from fluidsim_tpu_torch.state import zeros_state

    dev = torch.device(args.device)
    n = args.n
    cfg = preset_sharded_512().replace(size=n, pressure_solver="fft")
    rng = np.random.default_rng(cs.SEED + 20)
    seeded = zeros_state(cfg, dev).replace(density=cs.density_field(n, rng, dev),
                                           velocity=cs.velocity_field(n, rng, dev, 0.5))
    out = {"n": n, "shards": args.shards, "steps": args.steps, "device": str(dev)}
    if args.transforms_only:
        out["transforms"] = transforms(2 * n, args.shards, dev)
        print(json.dumps(out), flush=True)
        return

    eng = Engine(cfg.replace(kernel_backend="xla"), device=args.device)
    eng.state = seeded
    eng.step(args.steps)
    mesh = make_mesh([args.device] * args.shards)
    step = sharded_step_fn(cfg, mesh)
    st = shard_state(seeded, mesh)
    for _ in range(args.steps):
        st = step(st)
    got = unshard_state(st)
    out["step"] = {}
    for f in ("density", "velocity", "pressure"):
        g, r = getattr(got, f).double(), getattr(eng.state, f).double()
        d, scale = (g - r).abs(), float(r.abs().max())
        out["step"][f] = {"max_abs_over_max": float(d.max()) / scale,
                          "past_rtol_over_max": float((d - 1e-5 * r.abs()).max()) / scale}
    del eng, st, got

    if args.transforms:
        out["transforms"] = transforms(2 * n, args.shards, dev)
    if args.no_f64:
        print(json.dumps(out), flush=True)
        return
    vel = seeded.velocity
    whole = fp.project_3d_fft(vel)
    res = fp.project_3d_fft_shards([c.contiguous() for c in torch.chunk(vel, args.shards, 1)])
    shards = (torch.cat([r[0] for r in res], 1), torch.cat([r[1] for r in res], 0))
    wide = project_f64(fp, vel)
    out["projection"] = {}
    for i, name in enumerate(("velocity", "pressure")):
        ref = wide[i]
        scale = float(ref.abs().max())
        out["projection"][name] = {
            "whole_vs_f64": float((whole[i].double() - ref).abs().max()) / scale,
            "shards_vs_f64": float((shards[i].double() - ref).abs().max()) / scale,
            "shards_vs_whole": float((shards[i].double() - whole[i].double()).abs().max())
            / scale}
    out["projection"]["max_p_over_max_v"] = float(wide[1].abs().max() / wide[0].abs().max())
    print(json.dumps(out), flush=True)


def transforms(m: int, shards: int, dev) -> dict:
    """Compositions of the (m, m, m) real 3D transform against ``rfftn`` and
    of its inverse against ``irfftn``."""
    import torch

    fft = torch.fft
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((m, m, m), device=dev, generator=g)
    ref = fft.rfftn(x)

    def by_slabs(f, t):
        return torch.cat([f(c) for c in torch.chunk(t, shards, 0)], 0)

    forward = {
        "rfft x, fft y, fft z": lambda: fft.fft(fft.fft(fft.rfft(x, dim=2), dim=1), dim=0),
        "rfft x, fft z, fft y": lambda: fft.fft(fft.fft(fft.rfft(x, dim=2), dim=0), dim=1),
        "rfft x, fftn (z, y)": lambda: fft.fftn(fft.rfft(x, dim=2), dim=(0, 1)),
        "rfft2 (y, x), fft z": lambda: fft.fft(fft.rfft2(x, dim=(1, 2)), dim=0),
        "rfft2 (y, x) on slabs, fft z": lambda: fft.fft(
            by_slabs(lambda c: fft.rfft2(c, dim=(1, 2)), x), dim=0),
        "rfft x, fft y on slabs, fft z": lambda: fft.fft(
            by_slabs(lambda c: fft.fft(fft.rfft(c, dim=2), dim=1), x), dim=0),
    }
    cols = [c.shape[2] for c in torch.tensor_split(ref, shards, dim=2)]

    def by_columns(f, t):
        """``f`` on each of ``shards`` blocks of columns (kx) of ``t``."""
        return torch.cat([f(c.contiguous()) for c in torch.tensor_split(t, shards, dim=2)], 2)

    forward["rfft x, fft z, fft y on column blocks"] = lambda: by_columns(
        lambda c: fft.fft(fft.fft(c, dim=0), dim=1), fft.rfft(x, dim=2))
    forward["rfft x, fftn (z, y) on column blocks"] = lambda: by_columns(
        lambda c: fft.fftn(c, dim=(0, 1)), fft.rfft(x, dim=2))
    out = {"column_blocks": cols}
    scale = float(ref.abs().max())
    for name, fn in forward.items():
        got = fn()
        out[name] = {"max_abs_over_max": float((got - ref).abs().max()) / scale,
                     "bitwise": bool(torch.equal(got, ref))}
        del got
    back = fft.irfftn(ref, s=(m, m, m))
    inverse = {
        "ifft z, ifft y, irfft x": lambda: fft.irfft(fft.ifft(fft.ifft(ref, dim=0), dim=1),
                                                     n=m, dim=2),
        "ifft z, irfft2 (y, x)": lambda: fft.irfft2(fft.ifft(ref, dim=0), s=(m, m),
                                                    dim=(1, 2)),
        "ifft z, irfft2 (y, x) on slabs": lambda: by_slabs(
            lambda c: fft.irfft2(c, s=(m, m), dim=(1, 2)), fft.ifft(ref, dim=0)),
        "ifft y, ifft z, irfft x": lambda: fft.irfft(fft.ifft(fft.ifft(ref, dim=1), dim=0),
                                                     n=m, dim=2),
        "ifftn (z, y), irfft x": lambda: fft.irfft(fft.ifftn(ref, dim=(0, 1)), n=m, dim=2),
        "ifft y, ifft z on column blocks, irfft x on slabs": lambda: by_slabs(
            lambda c: fft.irfft(c, n=m, dim=2),
            by_columns(lambda c: fft.ifft(fft.ifft(c, dim=1), dim=0), ref)),
        "ifftn (z, y) on column blocks, irfft x on slabs": lambda: by_slabs(
            lambda c: fft.irfft(c, n=m, dim=2),
            by_columns(lambda c: fft.ifftn(c, dim=(0, 1)), ref)),
        "ifft z, ifft y on column blocks, irfft x on slabs": lambda: by_slabs(
            lambda c: fft.irfft(c, n=m, dim=2),
            by_columns(lambda c: fft.ifft(fft.ifft(c, dim=0), dim=1), ref)),
    }
    scale = float(back.abs().max())
    for name, fn in inverse.items():
        got = fn()
        out[name] = {"max_abs_over_max": float((got - back).abs().max()) / scale,
                     "bitwise": bool(torch.equal(got, back))}
        del got
    return out


def project_f64(fp, vel):
    """``project_3d_fft``'s formula in float64 throughout."""
    import numpy as np
    import torch

    n = vel.shape[-1]
    ext = [fp._mirror(vel[c].double(), fp._PARITIES[c]) for c in range(3)]
    div = fp._cdiff(ext[0], 2) + fp._cdiff(ext[1], 1) + fp._cdiff(ext[2], 0)
    rhs_hat = torch.fft.rfftn(4.0 * div)
    total = None
    for ax in range(3):
        m = div.shape[ax]
        freqs = (np.arange(rhs_hat.shape[-1]) / m if ax == 2 else np.fft.fftfreq(m))
        lam = 2.0 * np.cos(4.0 * np.pi * freqs) - 2.0
        shape = [1, 1, 1]
        shape[ax] = len(freqs)
        lam = lam.reshape(shape)
        total = lam if total is None else total + lam
    inv = np.where(np.abs(total) > 1e-8, 1.0 / np.where(total == 0, 1, total), 0.0)
    p_ext = torch.fft.irfftn(rhs_hat * torch.from_numpy(inv).to(div.device), s=div.shape)
    out = [ext[0] - fp._cdiff(p_ext, 2), ext[1] - fp._cdiff(p_ext, 1),
           ext[2] - fp._cdiff(p_ext, 0)]
    return torch.stack([fp._crop(o, n) for o in out]), fp._crop(p_ext, n)


if __name__ == "__main__":
    main()
