"""ctypes bindings to the native fastio library, with numpy/zlib fallbacks
(a copy of the JAX package's ``io/native.py`` that builds its own library).

``native/fastio.cpp`` is compiled at first use, with ``g++ -O3 -fPIC
-shared ... -lz``, into ``build/fastio/`` of the checkout (git-ignored),
named by a hash of the source and the flags; a build of the same source is
loaded as it is. The committed ``native/libfastio.so`` is never loaded: it
was built with ``-march=native`` on another host and may use instructions
(AVX-512) that this host's CPU lacks. The build takes no ``-march`` flag,
so the library runs on any x86-64 host. Where no compiler or zlib header
is found, every entry point takes its numpy/zlib fallback: these are host
I/O, not device kernels. ``route()`` says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "fastio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fastio"
CXX_FLAGS = ["-O3", "-fPIC", "-Wall", "-shared"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ROUTE = "not loaded yet"


def library_path() -> Path:
    """Where the build of this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/fastio.cpp`` into ``BUILD_DIR`` unless a build of the
    same source and flags is there; returns the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a name of our own, then rename: concurrent builds (test
    # workers) each land a whole library, never a partial one.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lz"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def route() -> str:
    """Which route the entry points take: the native library (with its build
    time if this process built it) or the numpy/zlib fallback (and why)."""
    get_lib()
    return _ROUTE


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _ROUTE
    if _TRIED:
        return _LIB
    _TRIED = True
    t0 = time.perf_counter()
    try:
        found = library_path().exists()
        path = build()
        seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:
        _ROUTE = f"numpy/zlib fallback ({str(e).strip().splitlines()[0]})"
        return None
    lib.encode_png_rgb8.restype = ctypes.c_long
    lib.encode_png_rgb8.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long,
    ]
    lib.format_floats_6f.restype = ctypes.c_long
    lib.format_floats_6f.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_void_p, ctypes.c_long,
    ]
    lib.jet_colormap.restype = None
    lib.jet_colormap.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    _LIB = lib
    _ROUTE = f"native {path.name} " + ("(found built)" if found else f"(built in {seconds:.2f} s)")
    return _LIB


def encode_png_rgb8(rgb: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    lib = get_lib()
    if lib is not None:
        cap = h * w * 3 + (h * w * 3) // 2 + 4096
        out = np.empty(cap, np.uint8)
        n = lib.encode_png_rgb8(rgb.ctypes.data, w, h, level, out.ctypes.data, cap)
        if n > 0:
            return out[:n].tobytes()
    # Fallback: pure python
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def format_floats_6f(data: np.ndarray, header: str = "") -> bytes:
    """np.savetxt(fmt='%.6f', delimiter=' ') byte-equivalent text."""
    data = np.ascontiguousarray(data, np.float32)
    if data.ndim == 1:
        data = data[None, :]
    rows, cols = data.shape
    lib = get_lib()
    if lib is not None:
        cap = rows * cols * 32 + len(header) + 64
        out = np.empty(cap, np.uint8)
        n = lib.format_floats_6f(
            data.ctypes.data, rows, cols,
            header.encode() if header else None, out.ctypes.data, cap,
        )
        if n > 0:
            return out[:n].tobytes()
    lines = []
    if header:
        lines.append(header)
    for r in range(rows):
        lines.append(" ".join(f"{v:.6f}" for v in data[r]))
    return ("\n".join(lines) + "\n").encode()


# The EXACT cv2.applyColorMap(..., COLORMAP_JET) LUT (captured from OpenCV
# 5.0, byte-tested vs cv2 in tests/test_io.py) — the reference's depth viz
# uses it directly (generate_construction_data.py:1690-1709). Hex planes B/G/R.
_JET_B = bytes.fromhex(
    "8084888c9094989ca0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fcffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffefaf6f2eeeae6e2dedad6d2"
    "cecac6c2bebab6b2aeaaa6a29e9a96928e8a86827e7a76726e6a66625e5a56524e4a4642"
    "3e3a36322e2a26221e1a16120e0a06010000000000000000000000000000000000000000"
    "000000000000000000000000000000000000000000000000000000000000000000000000"
    "000000000000000000000000000000000000000000000000000000000000000000000000"
    "00000000")
_JET_G = bytes.fromhex(
    "00000000000000000000000000000000000000000000000000000000000000000004080c"
    "1014181c2024282c3034383c4044484c5054585c6064686c7074787c8084888c9094989c"
    "a0a4a8acb0b4b8bcc0c4c8ccd0d4d8dce0e4e8ecf0f4f8fcffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0"
    "aca8a4a09c9894908c8884807c7874706c6864605c5854504c4844403c3834302c282420"
    "1c1814100c08040000000000000000000000000000000000000000000000000000000000"
    "00000000")
_JET_R = bytes.fromhex(
    "000000000000000000000000000000000000000000000000000000000000000000000000"
    "000000000000000000000000000000000000000000000000000000000000000000000000"
    "00000000000000000000000000000000000000000000000002060a0e12161a1e22262a2e"
    "32363a3e42464a4e52565a5e62666a6e72767a7e82868a8e92969a9ea2a6aaaeb2b6babe"
    "c2c6caced2d6dadee2e6eaeef2f6fafeffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffcf8f4f0ece8e4e0dcd8d4d0ccc8c4c0bcb8b4b0aca8a4a09c989490"
    "8c888480")
_JET_LUT_BGR = np.stack([
    np.frombuffer(_JET_B, np.uint8),
    np.frombuffer(_JET_G, np.uint8),
    np.frombuffer(_JET_R, np.uint8),
], axis=-1)


def jet_colormap(gray: np.ndarray) -> np.ndarray:
    """uint8 (...,) -> BGR uint8 (..., 3), exact cv2 COLORMAP_JET."""
    gray = np.ascontiguousarray(gray, np.uint8)
    flat = gray.reshape(-1)
    lib = get_lib()
    if lib is not None:
        out = np.empty((flat.size, 3), np.uint8)
        lib.jet_colormap(flat.ctypes.data, out.ctypes.data, flat.size)
        return out.reshape(gray.shape + (3,))
    return _JET_LUT_BGR[flat].reshape(gray.shape + (3,))
