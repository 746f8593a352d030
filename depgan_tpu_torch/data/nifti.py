"""Native NIfTI-1 I/O and orientation transforms.

Counterpart of ``depgan_tpu/data/nifti.py``: a numpy copy, so the port
imports nothing of the JAX package.

The reference delegates NIfTI I/O to nibabel (`load_data` class,
`...twoCritics_training_4fold.py:93-102`; testing variant with ``pixdim`` at
`DEP-GAN_testing_4fold.py:73-83`). This framework ships its own NIfTI-1
reader/writer (pure numpy, .nii and .nii.gz) so the data layer has no
third-party dependency; a C++ fast path with the same interface lives in
`native/`.

Also provides the reference's orientation transforms:

- :func:`volume_to_slices` — 3-D volume -> stack of 2-D axial slices, NHWC
  float32 (`data_prep`, reference :105-119).
- :func:`slices_to_volume` — inverse transform used before saving
  (`data_prep_save`, reference :122-128): squeeze -> swapaxes(0,2) -> rot90
  -> flip axis 0.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# NIfTI-1 datatype codes -> numpy dtypes.
_NIFTI_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}

_HDR_SIZE = 348


@dataclass
class NiftiVolume:
    """A loaded NIfTI volume.

    Mirrors the reference's ``load_data`` object surface
    (`DEP-GAN_testing_4fold.py:73-83`): ``image`` (voxel array), ``affine``
    (4x4 voxel->world), ``pixdim`` (spatial voxel dims, mm), ``dt``
    (temporal pixdim[4]).
    """

    image: np.ndarray
    affine: np.ndarray
    pixdim: np.ndarray  # pixdim[1:4] — spatial voxel sizes
    dt: float = 0.0  # pixdim[4]
    header: dict = field(default_factory=dict)

    @property
    def voxel_volume_mm3(self) -> float:
        return float(np.prod(self.pixdim))


def _open_maybe_gzip(path: Path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _quaternion_to_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    qfac = 1.0 if hdr["pixdim"][0] >= 0 else -1.0
    pix = np.array([hdr["pixdim"][1], hdr["pixdim"][2], hdr["pixdim"][3] * qfac])
    affine = np.eye(4)
    affine[:3, :3] = R * pix
    affine[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return affine


def read_header(raw: bytes) -> dict:
    """Parse the 348-byte NIfTI-1 header into a dict."""
    if len(raw) < _HDR_SIZE:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr = struct.unpack(">i", raw[0:4])[0]
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"

    def unpack(fmt, off, n):
        return struct.unpack(endian + fmt, raw[off : off + n])

    hdr: dict = {"endian": endian}
    hdr["dim"] = np.array(unpack("8h", 40, 16))
    hdr["datatype"] = unpack("h", 70, 2)[0]
    hdr["bitpix"] = unpack("h", 72, 2)[0]
    hdr["pixdim"] = np.array(unpack("8f", 76, 32), dtype=np.float64)
    hdr["vox_offset"] = unpack("f", 108, 4)[0]
    hdr["scl_slope"] = unpack("f", 112, 4)[0]
    hdr["scl_inter"] = unpack("f", 116, 4)[0]
    hdr["qform_code"] = unpack("h", 252, 2)[0]
    hdr["sform_code"] = unpack("h", 254, 2)[0]
    (
        hdr["quatern_b"],
        hdr["quatern_c"],
        hdr["quatern_d"],
        hdr["qoffset_x"],
        hdr["qoffset_y"],
        hdr["qoffset_z"],
    ) = unpack("6f", 256, 24)
    hdr["srow_x"] = np.array(unpack("4f", 280, 16))
    hdr["srow_y"] = np.array(unpack("4f", 296, 16))
    hdr["srow_z"] = np.array(unpack("4f", 312, 16))
    hdr["magic"] = raw[344:348].rstrip(b"\x00")
    return hdr


def load(path: str | Path) -> NiftiVolume:
    """Load a .nii / .nii.gz volume (scl_slope/inter applied if set)."""
    path = Path(path)
    with _open_maybe_gzip(path) as f:
        raw = f.read()
    hdr = read_header(raw)

    ndim = int(hdr["dim"][0])
    shape = tuple(int(d) for d in hdr["dim"][1 : 1 + max(ndim, 1)])
    dtype = _NIFTI_DTYPES.get(hdr["datatype"])
    if dtype is None:
        raise ValueError(f"unsupported NIfTI datatype code {hdr['datatype']}")
    count = int(np.prod(shape)) if shape else 0
    offset = int(hdr["vox_offset"])
    data = np.frombuffer(
        raw, dtype=np.dtype(dtype).newbyteorder(hdr["endian"]), count=count, offset=offset
    )
    # NIfTI data is Fortran-ordered (x fastest).
    image = data.reshape(shape, order="F")

    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter != 0.0:
        image = image * np.float32(slope if slope != 0.0 else 1.0) + np.float32(inter)

    if hdr["sform_code"] > 0:
        affine = np.vstack([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"], [0, 0, 0, 1]])
    elif hdr["qform_code"] > 0:
        affine = _quaternion_to_affine(hdr)
    else:
        affine = np.diag([*hdr["pixdim"][1:4], 1.0])

    return NiftiVolume(
        image=np.asarray(image),
        affine=affine.astype(np.float64),
        pixdim=hdr["pixdim"][1:4].copy(),
        dt=float(hdr["pixdim"][4]),
        header=hdr,
    )


def save(image: np.ndarray, affine: np.ndarray, path: str | Path, pixdim=None) -> None:
    """Write a NIfTI-1 single-file (.nii, gzipped when the name ends .gz)."""
    path = Path(path)
    image = np.asarray(image)
    if image.dtype not in _DTYPE_CODES:
        image = image.astype(np.float32)
    dt_code = _DTYPE_CODES[image.dtype]
    bitpix = image.dtype.itemsize * 8

    if pixdim is None:
        # Derive spatial pixdims from affine column norms.
        pixdim = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)
    dims = np.ones(8, dtype=np.int16)
    dims[0] = image.ndim
    dims[1 : 1 + image.ndim] = image.shape
    pixd = np.zeros(8, dtype=np.float32)
    pixd[0] = 1.0
    pixd[1:4] = pixdim[:3]

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, dt_code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixd)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code (aligned)
    affine = np.asarray(affine, dtype=np.float32)
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + image.tobytes(order="F")
    if path.suffix == ".gz":
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def load_auto(path: str | Path) -> NiftiVolume:
    """Load via the native C++ reader (native/niftio.cpp) when built, else
    the pure-numpy reader. The native path returns float32 voxels — fine for
    every pipeline here, which converts to float32 at slice extraction
    anyway (reference `data_prep`, :112)."""
    from . import native

    if native.available():
        try:
            return native.load_native(path)
        except OSError:  # a file the C++ reader does not take: the numpy reader's turn
            pass
    return load(path)


def volume_to_slices(volume: np.ndarray) -> np.ndarray:
    """3-D volume (X, Y, Z) -> axial slice stack (Z, X, Y, 1) float32 NHWC.

    Faithful to the reference's ``data_prep``
    (`...twoCritics_training_4fold.py:105-119`), which stacks ``image[:, :, z]``
    slices then adds a channel axis.
    """
    volume = np.asarray(volume)
    if volume.ndim == 4:  # some NIfTIs carry a trailing singleton dim
        volume = np.squeeze(volume, axis=-1)
    slices = np.moveaxis(volume, 2, 0).astype(np.float32)
    return slices[..., None]


def slices_to_volume(slices: np.ndarray) -> np.ndarray:
    """Inverse save-orientation transform (`data_prep_save`, reference :122-128).

    squeeze -> swapaxes(0, 2) -> rot90 -> flip axis 0, returning the array in
    the on-disk NIfTI orientation.
    """
    image = np.squeeze(np.asarray(slices))
    out = np.swapaxes(image, 0, 2)
    out = np.rot90(out)
    return out[::-1, ...]
