"""Builds the CUDA sources in ``fluidsim_tpu_torch/csrc/`` and loads them.

``nvcc`` compiles every ``*.cu`` file, one process per file, all started
together, and links the objects into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds), which is loaded
with ``ctypes``.  The library goes into ``fluidsim_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is.  ``-Xptxas -v`` reports each
kernel's registers and spills into a log file beside the library.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into one
FMA, so each kernel performs the same float32 operations, in the same order,
as its plain PyTorch twin and the two compare bitwise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class SolveBlock(ctypes.Structure):
    """``fsk::SolveBlock`` (``csrc/sweep_block.cuh``): K5's sweep block, its
    float32 constants and its scratch pointers."""

    _fields_ = [("block", _I)] + [
        (name, _F) for name in ("a", "ic", "aic", "aicic", "a2", "a2ic2", "aT")
    ] + [(name, _P) for name in ("x1", "w0", "w1", "s0", "s1")]


_B = ctypes.POINTER(SolveBlock)


class SolveTiles(ctypes.Structure):
    """``fsk::SolveTiles`` (``csrc/solve_tiled.cuh``): the tiled solve's
    tiles along x, y and z, its zeroed flags and its face buffer."""

    _fields_ = [("gx", _I), ("gy", _I), ("gz", _I), ("flags", _P), ("faces", _P)]


_T = ctypes.POINTER(SolveTiles)


class HaloArray(ctypes.Structure):
    """``fsk::HaloArray`` (``csrc/halo_copy.cuh``): one array of a K13 call on
    one shard, its source planes, its output and its neighbours' outputs."""

    _fields_ = [("src", _P), ("out", _P), ("out_lo", _P), ("out_hi", _P),
                ("src_cstride", ctypes.c_longlong), ("channels", _I), ("elem", _I)]

# C entry points: name -> argument types (each returns an int: a cudaError_t,
# or for fs_full_step_blocks a block count, for fs_smem_optin bytes, for
# fs_current_device a device index).
SIGNATURES = {
    # fields, vel, dens, mask, emitter, src_on, out, tmp0, tmp1, n, n_fields,
    # b0, b1, b2, dt0_sub, n_sub, window, has_buoy, buoy_dt, buoyancy,
    # ambient, gravity, scale, field_bf16, stream
    "fs_advect_k1": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                     _I, _I, _I, _F, _F, _F, _F, _F, _I, _P),
    # vel, mask, vel_out, p_out, p_a, p_b, rhs, n, iters, solve_bf16,
    # field_bf16, damp, blk, tiles, stream
    "fs_project": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _B, _T, _P),
    # vel, dens, mask, emitter, vel_out, p_out, dens_out, tmp0, tmp1, p_a, p_b,
    # rhs, n, iters, solve_bf16, field_bf16, dt0_sub, n_sub, window, damp,
    # dens_damp, blk, tiles, stream
    "fs_project_advect_density": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _F, _I, _I, _F, _F, _B, _T, _P),
    # (returns the shared memory a block may opt in to on the current
    # device, or -error)
    "fs_smem_optin": (),
    # vel, dens, adv, vel_out, p_out, dens_out, tmp0, tmp1, p_a, p_b, rhs, n,
    # iters, solve_bf16, field_bf16, dt0_sub, n_sub, window, damp, dens_damp,
    # blk, tiles, votes, stream
    "fs_full_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _F, _I, _I, _F, _F, _B, _T, _P, _P),
    # vel, adv, vel_out, p_out, p_a, p_b, rhs, n, iters, dt0_sub, n_sub,
    # window, tiles, votes, stream
    "fs_advect_project": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _T, _P, _P),
    # solve_bf16, field_bf16, window, n, gx, gy, gz, block (returns the
    # cooperative grid's block count, or -error)
    "fs_full_step_blocks": (_I, _I, _I, _I, _I, _I, _I, _I),
    # x, x0, out, tmp, n, b, a, inv_c, iters, stream
    "fs_jacobi": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _P),
    # x, x0, mask, out, tmp, n, b, a, inv_c, iters, blk, tiles, stream
    "fs_jacobi_resident": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _B, _T, _P),
    # x, x0, mask, out, tmp, nz, n, b, a, inv_c, t_iters, wall_lo, wall_hi,
    # stream
    "fs_jacobi_ext": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _P),
    # x, x0, mask, out, tmp, spare, out_lo, out_hi, nz, n, b, a, inv_c,
    # t_iters, wall_lo, wall_hi, stream
    "fs_jacobi_ext_rdma": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I,
                           _P),
    # arrays, n_arrays, lz, h, n, stream
    "fs_halo_exchange": (ctypes.POINTER(HaloArray), _I, _I, _I, _I, _P),
    # fields, vel, mask, out, tmp0, tmp1, n, nz, zoff, n_fields, b0, b1, b2,
    # dt0_sub, n_sub, window, field_bf16, stream
    "fs_advect_ext": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                      _P),
    # x, x0, mask, out, tmp, n, b, a, c, iters, smooth, blocks, strips, stream
    "fs_solve_2d": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _P),
    # blocks, syncs, stream
    "fs_cluster_barriers": (_I, _I, _P),
    # vel, div, n, stream
    "fs_divergence": (_P, _P, _I, _P),
    # vel, p, vel_out, n, stream
    "fs_gradient": (_P, _P, _P, _I, _P),
    # vel, cstride, vz_lo, vz_hi, div, n, lz, wall_lo, wall_hi, stream
    "fs_divergence_ext": (_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _P),
    # vel, cstride, p, p_lo, p_hi, vel_out, n, lz, wall_lo, wall_hi, stream
    "fs_gradient_ext": (_P, ctypes.c_longlong, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # device, peer (csrc/peer.cu: the mesh's peer access)
    "fs_enable_peer": (_I, _I),
    # (returns the current device as the library's runtime sees it, or -error)
    "fs_current_device": (),
    # dst, dpitch, src, spitch, width, height, stream (bytes; rows)
    "fs_copy_rows": (_P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _P),
}


class BuildError(RuntimeError):
    """The CUDA sources could not be compiled or loaded."""


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``).  Raises ``BuildError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise BuildError(
        "nvcc not found (searched PATH and "
        f"{candidate}); the CUDA toolkit is needed to build the kernels"
    )


def _sources(csrc_dir: Path):
    return sorted(csrc_dir.glob("*.cu")) + sorted(csrc_dir.glob("*.cuh")) \
        + sorted(csrc_dir.glob("*.h"))


def library_path(csrc_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc_dir):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return build_dir / f"libfluidsim_kernels_{digest.hexdigest()[:16]}.so"


def build(csrc_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the sources unless the library for them exists; return its
    path.  Raises ``BuildError`` with the compiler's output on failure."""
    so = library_path(csrc_dir, build_dir)
    if so.exists():
        return so
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    units = sorted(csrc_dir.glob("*.cu"))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as obj_dir:
            objs = [str(Path(obj_dir) / f"{u.stem}.o") for u in units]
            procs = [
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(csrc_dir), "-c", str(u), "-o", o],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for u, o in zip(units, objs)
            ]
            logs = [p.communicate()[0] for p in procs]
            log = "".join(f"== {u.name}\n{text}" for u, text in zip(units, logs))
            failed = [u.name for u, p in zip(units, procs) if p.returncode != 0]
            if failed:
                raise BuildError(f"nvcc failed on {', '.join(failed)}:\n{log}")
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed ({proc.returncode}):\n"
                                 f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fs_error_string.argtypes = [ctypes.c_int]
    lib.fs_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.fs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
