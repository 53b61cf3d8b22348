"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source compiles with its own nvcc, all started together, and
the objects link into one shared library with a plain C interface for
``sm_90a`` (Hopper), which is loaded with ctypes: no PyTorch headers are
compiled, so a cold build takes seconds. The library lands in
``build/torch_kernels/`` of the checkout, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads the
existing build. Nothing is built at import time: the first kernel launch
builds. A failed build raises; there is no fallback.

Each wrapper passes device pointers and PyTorch's current stream as
integers and raises if the entry point's ``cudaGetLastError()`` code is
not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64
SIGNATURES = {
    "cspe_sweep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "cspe_rgb": [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P],
    "cspe_rgb_tier": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "cspe_heatmap": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _P],
    "cspe_peaks": [_P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "cspe_mesh_sweep": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                        _P],
    "cspe_raycast": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P],
    "cspe_mesh_terms": [_P] * 12 + [_I] * 5 + [_P] * 5,
    "cspe_draws": [_P, _I, _P, _I, _I, _U64, _U64, _U64, _P, _I, _I, _I, _P, _P],
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the build directory unless a build of the
    same sources and flags is there. Returns the library's path."""
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libcspe_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        cus = sorted(CSRC.glob("*.cu"))
        objs = [str(Path(work) / f"{f.stem}.o") for f in cus]
        cmds = [[nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
                 "-o", o, str(f)] for o, f in zip(objs, cus)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        link = [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(Path(work) / "lib.so"), *objs]
        if all(rc == 0 for _, _, rc in results):
            proc = subprocess.run(link, capture_output=True, text=True)
            results.append((link, proc.stdout + proc.stderr, proc.returncode))
        for cmd, out, rc in results:
            if verbose or rc != 0:
                print(out, flush=True)
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}")
        os.replace(Path(work) / "lib.so", lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cspe_error_string.argtypes = [ctypes.c_int]
    lib.cspe_error_string.restype = ctypes.c_char_p
    return lib


def ptxas_report(source: str = "rgb.cu") -> dict:
    """{kernel: {"registers": n, "spill_bytes": m}} of ``csrc/<source>``,
    compiled once more with ``-Xptxas -v``; a template's instantiations are
    named by their arguments, e.g. ``rgb_kernel<false, 0>``."""
    with tempfile.TemporaryDirectory() as work:
        cmd = [nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(Path(work) / "k.o"), str(CSRC / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {proc.stdout}{proc.stderr}")
    return parse_ptxas(proc.stdout + proc.stderr)


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one (``_ZN...``, as ptxas and
    cuobjdump print it), with a template's arguments: e.g.
    ``rgb_kernel<false, 0>``."""
    # The nested name: <length><identifier> pieces, then the template
    # arguments (Lb0E false, Li7E 7, Lin1E -1).
    mangled = mangled.removeprefix("_ZN")
    pos, kernel = 0, None
    while (d := re.match(r"\d+", mangled[pos:])) and kernel is None:
        ident = mangled[pos + d.end():pos + d.end() + int(d.group())]
        pos += d.end() + len(ident)
        kernel = ident if ident.endswith("_kernel") else None
    args = re.findall(r"L([bi])(n?\d+)E", mangled[pos:]) if mangled[pos:pos + 1] == "I" else []
    conv = {"b0": "false", "b1": "true"}
    targs = [conv.get(k + v, v.replace("n", "-")) for k, v in args]
    return f"{kernel}<{', '.join(targs)}>" if targs else kernel


def parse_ptxas(report: str) -> dict:
    """The registers and spill-store bytes of each kernel in ``nvcc -Xptxas
    -v`` output (see ``ptxas_report``)."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?_ZN(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and "spill stores" in line:
            out.setdefault(name, {})["spill_bytes"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
    return out


def launch(name: str, *args) -> None:
    """Call entry point ``name`` on the current stream; raise on a launch
    error. Tensor arguments pass as device pointers."""
    lib = library()
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, name)(*conv, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: {lib.cspe_error_string(err).decode()}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and of
    ``shape`` where given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
