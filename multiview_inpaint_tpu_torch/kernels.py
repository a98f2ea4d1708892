"""Build, bind and count the port's CUDA kernels.

The sources in ``multiview_inpaint_tpu_torch/csrc/*.cu`` export a plain C
interface (``composite_common.cuh`` holds the per-splat math that the
composite kernel and its backward share). At first use they are compiled
by ``nvcc`` for Hopper (``sm_90a``), one process per source, all started
together, and linked into ``build/kernels/libmvi_kernels.so`` at the root
of the checkout, which is then loaded with ``ctypes``. A stamp of the
sources, the header and the flags lets later processes reuse the library.
Every pointer and the stream pass as ``c_void_p``; each C function
returns ``cudaGetLastError()`` (or an argument error) and ``check`` raises
on anything but 0. The rasterizer (K1-K3), the projection (K6 and its
backward K7, built with ``-fmad=false``: ``SOURCE_FLAGS`` holds a
source's own flags) and the diffusion stack (K4, K5;
``flash_attn_common.cuh`` holds their TMA, mbarrier and wgmma helpers)
share this one build. The flash kernels' TMA tensor maps are encoded on
the host with the driver's ``cuTensorMapEncodeTiled``, fetched at run
time through ``cudaGetDriverEntryPoint``, so nothing links against
``libcuda``. Each source's ``ptxas`` report (registers, spills) is kept
beside the library as ``<source>.ptxas.txt``; ``ptxas_report`` reads it.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where
it launches its kernel, and nowhere else. It is a view of the
``launch.<kernel>`` counters of ``telemetry``, not a count of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import telemetry

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libmvi_kernels.so"
SOURCES = ("pair_expand.cu", "composite.cu", "composite_bwd.cu",
           "flash_attn_fwd.cu", "flash_attn_bwd.cu", "project.cu",
           "project_bwd.cu")
HEADERS = ("composite_common.cuh", "flash_attn_common.cuh")
# No --use_fast_math: __expf/__logf would break the 3e-5 parity bar.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# Flags of one source's compile step. K6 rounds every operation as the
# plain path's PyTorch ops do, so no multiply and add may fuse; K7
# recomputes K6's forward to the bit, so that its clamps and the
# colour's cut at 0 take the sides the forward took.
SOURCE_FLAGS = {"project.cu": ("-fmad=false",),
                "project_bwd.cu": ("-fmad=false",)}
PTXAS_VERBOSE = ("-Xptxas", "-v")   # compile step only

LAUNCHES = telemetry.LAUNCHES
reset_launches = telemetry.reset_launches
LAUNCHES.update(dict.fromkeys(("pair_expand", "composite", "composite_bwd",
                               "flash_attn_fwd", "flash_attn_bwd",
                               "project", "project_bwd"), 0))

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # starts, x0, y0, w, n_active, total, tiles_x, keys, stream
    "mvi_expand_keys": (_P, _P, _P, _P, _I, _L, _I, _P, _P),
    # attrs, seg_start, counts, item_end (or NULL), order (or NULL), state
    # (or NULL), out, num_tiles, tiles_x, tile_w, tile_h, band row0, band
    # stride, box shrink, stream
    "mvi_composite": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _F, _P),
    # K2 at threads per block, int[1] out: blocks per SM
    "mvi_composite_residency": (_I, _P),
    # attrs, seg_start, counts, item_end, state, fwd, grad, d_attrs,
    # num_tiles, max_items, tiles_x, tile_w, tile_h, band row0, band
    # stride, stream
    "mvi_composite_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    # q, k, v, o, lse (or NULL), is_f32, batch, heads, t, d, batch
    # stride, row stride, head stride, scale, stream
    "mvi_flash_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                           _L, _F, _P),
    # q, k, v, dO, lse, delta, dq, dk, dv, is_f32, batch, heads, t, d,
    # batch stride, row stride, head stride, scale, stream
    "mvi_flash_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _L, _L, _L, _F, _P),
    # dynamic shared memory bytes: forward at padded head dim; backward
    # kernel (0 dk/dv, 1 dq) at padded head dim
    "mvi_flash_attn_fwd_smem": (_I,),
    "mvi_flash_attn_bwd_smem": (_I, _I),
    # K3 at threads per block, int[2] out: blocks per SM, splats per warp
    # reduction
    "mvi_composite_bwd_residency": (_I, _P),
    # xyz, features_dc, features_rest, opacity, scaling, rotation, live,
    # world_view, full_proj, campos, n, rest floats a row, SH degree,
    # width, height, focal x, y, 1.3 tan_fov x, y, scaling modifier;
    # means2d, conic, depth, radius, color, opacity, extent out; stream
    "mvi_project": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                    _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P),
    # xyz, features_dc, features_rest, opacity, scaling, rotation, radius,
    # world_view, full_proj, campos, then mvi_project's n .. scaling
    # modifier; the cotangents of means2d, conic, depth, color and
    # opacity, each (or NULL) with its row stride in floats; the
    # gradients of the six fields and of means2d_offset (or NULL) out;
    # stream
    "mvi_project_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _F, _P, _L, _P, _L, _P, _L,
                        _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P),
}

_lib = None


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from source at first use")


def _stamp() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile and link the kernels unless an up-to-date build exists;
    returns the library path."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp_path = BUILD_DIR / (LIB_NAME + ".stamp")
    stamp = _stamp()
    if (lib_path.exists() and stamp_path.exists()
            and stamp_path.read_text() == stamp):
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    # Objects and the library are made in a private directory and the
    # library renamed into place, so concurrent builds cannot mix files.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(work, Path(src).stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()),
                 *PTXAS_VERBOSE, "-c", str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors = []
        for src, proc in zip(SOURCES, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src}:\n{log}")
            else:
                (BUILD_DIR / (Path(src).stem + ".ptxas.txt")).write_text(log)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp = os.path.join(work, LIB_NAME)
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               tmp], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp, lib_path)
    stamp_path.write_text(stamp)
    return lib_path


def ptxas_report(src: str) -> list:
    """``(kernel, registers, spill stores, spill loads, static shared
    memory bytes)`` of each entry function of one source, from the ptxas
    report of the last build (an empty list where there is none)."""
    path = BUILD_DIR / (Path(src).stem + ".ptxas.txt")
    if not path.exists():
        return []
    out, name, spills = [], None, (0, 0)
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name is not None:
            words = line.replace(",", "").split()
            spills = (int(words[words.index("spill") - 2]),
                      int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name is not None:
            words = line.replace(",", "").split()
            smem = (int(words[words.index("smem") - 2]) if "smem" in words
                    else 0)
            out.append((name, int(words[words.index("Used") + 1]), *spills,
                        smem))
            name, spills = None, (0, 0)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
