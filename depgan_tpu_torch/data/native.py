"""ctypes bindings for the native NIfTI reader (native/niftio.cpp).

Counterpart of ``depgan_tpu/data/native.py``: a copy that binds the
repository's own library. It reads files and launches nothing on a device.

``load_native(path)`` mirrors :func:`depgan_tpu.data.nifti.load` but decodes
in C++ (zlib + dtype conversion in one pass); ``load_many`` fans a list of
volumes across a C++ thread pool — the per-subject load touches 9+ modality
files (`DEP-GAN_testing_4fold.py:502-521`), which the GIL would serialise.

The shared library is built by ``make -C native``; if it is absent every
entry point raises ``NativeUnavailable`` and callers fall back to the pure
numpy reader.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .nifti import NiftiVolume


class NativeUnavailable(RuntimeError):
    pass


class _NiftioHeader(ctypes.Structure):
    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("dims", ctypes.c_int32 * 7),
        ("datatype", ctypes.c_int32),
        ("pixdim", ctypes.c_float * 7),
        ("vox_offset", ctypes.c_float),
        ("scl_slope", ctypes.c_float),
        ("scl_inter", ctypes.c_float),
        ("srow", ctypes.c_float * 12),
        ("sform_code", ctypes.c_int32),
        ("qform_code", ctypes.c_int32),
    ]


_LIB = None


def _find_lib() -> Path | None:
    src_dir = Path(__file__).resolve().parents[2] / "native"
    lib = src_dir / "libdepgan_native.so"
    if lib.is_file():
        return lib
    # Build on demand (g++ + zlib, a couple of seconds).
    if (src_dir / "Makefile").is_file():
        import subprocess

        try:
            subprocess.run(["make", "-C", str(src_dir)], capture_output=True,
                           timeout=120, check=True)
        except (OSError, subprocess.SubprocessError):  # no compiler or no zlib here
            return None
        if lib.is_file():
            return lib
    return None


def get_lib():
    global _LIB
    if _LIB is None:
        path = _find_lib()
        if path is None:
            raise NativeUnavailable(
                "libdepgan_native.so not found; build with `make -C native`"
            )
        lib = ctypes.CDLL(str(path))
        lib.niftio_read_header.argtypes = [ctypes.c_char_p, ctypes.POINTER(_NiftioHeader)]
        lib.niftio_read_header.restype = ctypes.c_int
        lib.niftio_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(_NiftioHeader),
        ]
        lib.niftio_read_f32.restype = ctypes.c_long
        lib.niftio_read_many_f32.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(_NiftioHeader),
            ctypes.c_int,
        ]
        lib.niftio_read_many_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def _volume_from(header: _NiftioHeader, data: np.ndarray) -> NiftiVolume:
    ndim = header.ndim
    shape = tuple(header.dims[i] for i in range(max(ndim, 1)))
    image = data[: int(np.prod(shape))].reshape(shape, order="F")
    if header.sform_code > 0:
        srow = np.asarray(header.srow, dtype=np.float64).reshape(3, 4)
        affine = np.vstack([srow, [0, 0, 0, 1]])
    else:
        affine = np.diag([*np.asarray(header.pixdim[0:3]), 1.0])
    return NiftiVolume(
        image=image,
        affine=affine,
        pixdim=np.asarray(header.pixdim[0:3], dtype=np.float64),
        dt=float(header.pixdim[3]),
        header={"datatype": header.datatype},
    )


def load_native(path: str | Path) -> NiftiVolume:
    """Load one volume via the C++ reader (always float32 data)."""
    lib = get_lib()
    header = _NiftioHeader()
    rc = lib.niftio_read_header(str(path).encode(), ctypes.byref(header))
    if rc != 0:
        raise IOError(f"niftio header error {rc} for {path}")
    n = int(np.prod([header.dims[i] for i in range(max(header.ndim, 1))]))
    buf = np.empty(n, dtype=np.float32)
    rc = lib.niftio_read_f32(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(header),
    )
    if rc < 0:
        raise IOError(f"niftio read error {rc} for {path}")
    return _volume_from(header, buf)


def load_many(paths: list[str | Path], n_threads: int = 0) -> list[NiftiVolume]:
    """Load several volumes concurrently in C++ threads."""
    lib = get_lib()
    n = len(paths)
    if n == 0:
        return []
    headers = (_NiftioHeader * n)()
    # Header pass (cheap) to size the buffers.
    sizes = []
    for i, p in enumerate(paths):
        rc = lib.niftio_read_header(str(p).encode(), ctypes.byref(headers[i]))
        if rc != 0:
            raise IOError(f"niftio header error {rc} for {p}")
        sizes.append(
            int(np.prod([headers[i].dims[j] for j in range(max(headers[i].ndim, 1))]))
        )
    bufs = [np.empty(s, dtype=np.float32) for s in sizes]
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_bufs = (ctypes.POINTER(ctypes.c_float) * n)(
        *[b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for b in bufs]
    )
    c_caps = (ctypes.c_long * n)(*sizes)
    rc = lib.niftio_read_many_f32(c_paths, n, c_bufs, c_caps, headers, n_threads)
    if rc != 0:
        raise IOError(f"niftio batch read error {rc}")
    return [_volume_from(headers[i], bufs[i]) for i in range(n)]
