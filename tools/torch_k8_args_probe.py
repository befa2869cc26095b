#!/usr/bin/env python3
"""Probe of K8's kernel arguments on a CUDA card: does the whole-step kernel
(``csrc/full_step.cuh``) compute other values when K5's ``SolveBlock`` is a
member of ``FullStepArgs`` instead of a kernel argument of its own?

Run from the root of a checkout:  python3 tools/torch_k8_args_probe.py

It copies ``fluidsim_tpu_torch/csrc/`` into a temporary directory once per
variant, edits ``full_step.cuh`` there and builds the whole kernel library
from the copy (``kernels/_build.build``):

- ``current``: the sources as they are (the block a second argument);
- ``member``: ``SolveBlock`` the last member of ``FullStepArgs``, the kernel
  one argument;
- ``member-half``: ``member`` on half the cooperative grid;
- ``member-regs``: ``member`` without the launch bound's 4 blocks an SM
  (no 64-register cap, so no spills);
- ``current-half``: ``current`` on half the grid.

For each variant it prints ptxas's registers, spills and stack for K8's
float32-field kernels (both routes: ``full_step_kernel``, the grid-stride
one, and ``full_step_tiled_kernel``), the count of non-coherent global
loads (``LDG.E...CONSTANT``) and of local loads in their SASS
(``cuobjdump``), and then runs ``full_step_3d`` at 32^3 and 33^3 (K = 1, 2,
3; n_sub = 1, 2, 3; float32 and bfloat16 solves; sweep_block 1, the tiled
route, and 4, the grid-stride route) against its plain twin on the card,
one JSON line per case that is not bitwise and a summary line per variant.
The edits touch the grid-stride kernel's arguments only.  With ``--sanitize``, where ``compute-sanitizer`` exists, it
then runs the ``member`` variant's n_sub = 2 case under its memcheck,
initcheck and racecheck tools and prints the end of each report.

With ``--locate`` it builds ``current`` and ``member`` only and prints, for
K = 1, 2, 3 and n_sub = 1, 2, 3, which self-advection K14 and K8 ran (see
``locate``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SWAPS = {
    "member": [
        ("  int window;\n};", "  int window;\n  SolveBlock blk;\n};"),
        ("full_step_kernel(const FullStepArgs a, const SolveBlock blk) {",
         "full_step_kernel(const FullStepArgs a) {\n  const SolveBlock& blk = a.blk;"),
        ("  SolveBlock block = blk;\n  void* params[] = {&args, &block};",
         "  args.blk = blk;\n  void* params[] = {&args};"),
    ],
    "half": [("dim3(*blocks),", "dim3(*blocks / 2),")],
    "regs": [("constexpr int kFullStepMinBlocks = 4;", "constexpr int kFullStepMinBlocks = 1;")],
}
VARIANTS = {
    "current": [],
    "member": ["member"],
    "member-half": ["member", "half"],
    "member-regs": ["member", "regs"],
    "current-half": ["half"],
}


def variant_sources(name: str, work: Path) -> Path:
    """A copy of csrc/ with the variant's edits applied to full_step.cuh."""
    from fluidsim_tpu_torch.kernels import _build

    dst = work / name / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    path = dst / "full_step.cuh"
    text = path.read_text()
    for swap in VARIANTS[name]:
        for old, new in SWAPS[swap]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} found {text.count(old)} times")
            text = text.replace(old, new)
    path.write_text(text)
    return dst


def load(so: Path) -> ctypes.CDLL:
    from fluidsim_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fs_error_string.argtypes = [ctypes.c_int]
    lib.fs_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_k8(log: str) -> dict:
    """K8's float32-field kernels in full_step.cu's ptxas report: route and
    template arguments -> registers, spill stores/loads and stack bytes."""
    sec = log.split("== full_step.cu\n", 1)[1].split("\n== ", 1)[0]
    out = {}
    for m in re.finditer(r"full_step_(tiled_)?kernelI(\w+?)fLi(\d)ELb(\d)E\S*' for "
                         r"'sm_90a'\n.*\n\s*(\d+) bytes stack frame, (\d+) bytes spill "
                         r"stores, (\d+) bytes spill loads\n.*Used (\d+) registers", sec):
        tiled, types, window, dens, stack, spill_st, spill_ld, regs = m.groups()
        solve = "bf16" if "bfloat16" in types else "f32"
        key = f"route={'tiled' if tiled else 'grid'} solve={solve} K={window} dens={dens}"
        out[key] = {"regs": int(regs), "spill_st": int(spill_st), "spill_ld": int(spill_ld),
                    "stack": int(stack)}
    return out


def sass_k8(so: Path) -> dict:
    """Per K8 kernel of the library: non-coherent global loads and local
    loads in its SASS (cuobjdump), or the tool's error."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr[-300:]}
    out, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if re.search(r"full_step_(tiled_)?kernel", m.group(1)) else None
            if name:
                out[name] = {"ldg_constant": 0, "ldg": 0, "ldl": 0}
            continue
        if name and "LDG" in line:
            out[name]["ldg"] += 1
            out[name]["ldg_constant"] += "CONSTANT" in line
        if name and re.search(r"\bLDL\b", line):
            out[name]["ldl"] += 1
    return out


def fields(n: int, seed: int, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    vel = (rng.standard_normal((3, n, n, n)) * 0.5).astype(np.float32)
    dens = (np.abs(rng.standard_normal((n, n, n))) * 10.0).astype(np.float32)
    return torch.from_numpy(vel).to(device), torch.from_numpy(dens).to(device)


def cases():
    for n in (32, 33):
        for window in (1, 2, 3):
            for n_sub in (1, 2, 3):
                for solve in (None, "bfloat16"):
                    for block in (1, 4):
                        yield n, window, n_sub, solve, block


def run_cases(lib, only=None) -> dict:
    """full_step_3d with ``lib`` against full_step_3d_plain on the card."""
    import torch
    from fluidsim_tpu_torch.kernels import _build, resident

    _build.load_library = lambda: lib
    dev = torch.device("cuda")
    bad, total = [], 0
    for n, window, n_sub, solve, block in (only or cases()):
        vel, dens = fields(n, 1000 + n, dev)
        kw = dict(window=window, n_sub=n_sub, solve_dtype=solve, damp=0.999,
                  dens_damp=0.995, sweep_block=block)
        got = resident.full_step_3d(vel, dens, 12, 0.1, **kw)
        ref = resident.full_step_3d_plain(vel, dens, 12, 0.1, **kw)
        torch.cuda.synchronize()
        total += 1
        diffs = [float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)]
        if any(not torch.equal(g, r) for g, r in zip(got, ref)):
            bad.append({"n": n, "window": window, "n_sub": n_sub, "solve": solve,
                        "block": block,
                        "route": resident.fused_step_route(n, 12, solve, sweep_block=block),
                        "max_abs_diff(vel,p,dens)": diffs})
    return {"cases": total, "not_bitwise": bad}


def locate(lib) -> list:
    """Which self-advection the kernel ran: K14 (fs_advect_project) and K8
    (fs_full_step, whose adv keeps the y and z components of the
    self-advected velocity) called on buffers of their own at 32^3, their
    adv held against the twin and against alternatives made from it
    (substeps from the start velocity, the whole dt0 in one substep or in
    each, one substep too few or too many)."""
    import torch
    from fluidsim_tpu_torch.kernels import advect as kadv
    from fluidsim_tpu_torch.kernels.resident import VOTE_INTS

    dev, n, dt, iters = torch.device("cuda"), 32, 0.1, 12
    vel, dens = fields(n, 1032, dev)
    stream = torch.cuda.current_stream().cuda_stream
    orig = kadv.substep_dt0
    rows = []
    for window in (1, 2, 3):
        for n_sub in (1, 2, 3):
            d_sub, d_full = orig(dt, n, n_sub), orig(dt, n, 1)

            def twin(dt0, count):
                kadv.substep_dt0 = lambda *_: dt0
                try:
                    return kadv.advect_multi_3d_plain((1, 2, 3), vel, vel, dt, n_sub=count,
                                                      window=window)
                finally:
                    kadv.substep_dt0 = orig

            hyp = {"twin": twin(d_sub, n_sub), "one substep of dt0/n_sub": twin(d_sub, 1),
                   "one substep of dt0": twin(d_full, 1),
                   "n_sub substeps of dt0": twin(d_full, n_sub)}
            if n_sub > 1:
                hyp["n_sub-1 substeps"] = twin(d_sub, n_sub - 1)
            hyp["n_sub+1 substeps"] = twin(d_sub, n_sub + 1)
            e = lambda *s: torch.empty(*s, device=dev)
            adv, vel_out, p, pa, pb, rhs = e(3, n, n, n), e(3, n, n, n), e(n, n, n), \
                e(n, n, n), e(n, n, n), e(n, n, n)
            votes = torch.empty(VOTE_INTS, dtype=torch.int32, device=dev)
            err = lib.fs_advect_project(vel.data_ptr(), adv.data_ptr(), vel_out.data_ptr(),
                                        p.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                                        rhs.data_ptr(), n, iters, d_sub, n_sub, window, None,
                                        votes.data_ptr(), stream)
            adv8, vel8, dens8 = e(3, n, n, n), e(3, n, n, n), e(n, n, n)
            err8 = lib.fs_full_step(vel.data_ptr(), dens.data_ptr(), adv8.data_ptr(),
                                    vel8.data_ptr(), e(n, n, n).data_ptr(), dens8.data_ptr(),
                                    None, None, pa.data_ptr(), pb.data_ptr(), rhs.data_ptr(),
                                    n, iters, 0, 0, d_sub, n_sub, window, 1.0, 1.0, None,
                                    None, votes.data_ptr(), stream)
            torch.cuda.synchronize()
            row = {"window": window, "n_sub": n_sub, "err": [err, err8]}
            for name, h in hyp.items():
                row[name] = [torch.equal(adv, h), float((adv - h).abs().max()),
                             torch.equal(adv8[1:], h[1:]), float((adv8[1:] - h[1:]).abs().max())]
            rows.append(row)
    return rows


def sanitize(work: Path) -> None:
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(tool).exists():
        print(json.dumps({"compute-sanitizer": "not found"}), flush=True)
        return
    so = work / "member" / "build"
    for check in ("memcheck", "initcheck", "racecheck"):
        cmd = [tool, "--tool", check, sys.executable, __file__, "--one", str(so)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
            tail = (proc.stdout + proc.stderr)[-1500:]
            rc = proc.returncode
        except subprocess.TimeoutExpired:
            tail, rc = "timed out after 240 s", None
        print(json.dumps({"compute-sanitizer": check, "rc": rc, "tail": tail}), flush=True)


def main() -> None:
    import torch
    from fluidsim_tpu_torch.kernels import _build

    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        so = next(Path(sys.argv[2]).glob("*.so"))
        print(json.dumps(run_cases(load(so), only=[(32, 1, 2, None, 1)])), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    if "--locate" in sys.argv:
        work = Path(tempfile.mkdtemp(prefix="k8locate_", dir=ROOT / "_scratch"))
        try:
            for name in ("current", "member"):
                so = _build.build(variant_sources(name, work), work / name / "build")
                for row in locate(load(so)):
                    print(json.dumps({"variant": name, **row}), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    work = Path(tempfile.mkdtemp(prefix="k8probe_", dir=ROOT / "_scratch"))
    try:
        for name in VARIANTS:
            src = variant_sources(name, work)
            so = _build.build(src, work / name / "build")
            report = {"variant": name, "ptxas": ptxas_k8(so.with_suffix(".log").read_text()),
                      "sass": sass_k8(so)}
            report.update(run_cases(load(so)))
            print(json.dumps(report), flush=True)
        if "--sanitize" in sys.argv:
            sanitize(work)
    finally:
        if "--keep" not in sys.argv:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
