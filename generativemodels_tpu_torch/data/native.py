"""ctypes bindings for the port's host data loader (`csrc/dataloader.cpp`).

Counterpart of generativemodels_tpu/data/native.py: NIfTI-1 reading, PNG
and JPEG decoding, and a multi-threaded prefetch loader whose workers
decode ahead of the consumer while it receives the files in the order of
the path list. The library is built with the C++ compiler (`$CXX`, else
g++) at first use, never at import, into the package's gitignored
`_build/`, named by a hash of the source and the flags. A decoder whose
header the compiler cannot find (libpng's png.h, libjpeg's jpeglib.h) is
left out of the build, and a file of its family then raises an error that
names that header. A failed build raises: nothing falls back to another
reader. The pure-Python NIfTI reader and writer (numpy and gzip) stay
for `read_nifti(native=False)` and for writing test data.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "dataloader.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-Wall")
# (header, define, link flag, the extensions it decodes)
DECODERS = (
    ("png.h", "GMTPU_HAVE_PNG", "-lpng", (".png",)),
    ("jpeglib.h", "GMTPU_HAVE_JPEG", "-ljpeg", (".jpg", ".jpeg")),
)
NATIVE_EXTS = (".nii", ".nii.gz") + tuple(e for d in DECODERS for e in d[3])
_ERR_LEN = 1024

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def has_header(header: str) -> bool:
    """Whether the C++ compiler finds `#include <header>` (after <cstdio>,
    which jpeglib.h needs before it)."""
    proc = subprocess.run(
        [_compiler(), "-fsyntax-only", "-x", "c++", "-"],
        input=f"#include <cstdio>\n#include <{header}>\n",
        capture_output=True, text=True,
    )
    return proc.returncode == 0


def build_library() -> Path:
    """Compile `csrc/dataloader.cpp` unless its hashed library exists; returns its path.

    Raises RuntimeError with the compiler's output on failure.
    """
    defines, libs = [], ["-lz", "-lpthread"]
    for header, define, link, _ in DECODERS:
        if has_header(header):
            defines.append(f"-D{define}")
            libs.insert(-1, link)
    flags = [*CXX_FLAGS, *defines]
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join([_compiler(), *flags, *libs]).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"dataloader-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([_compiler(), *flags, str(SOURCE), *libs, "-o", tmp],
                                  capture_output=True, text=True)
        except FileNotFoundError as exc:
            raise RuntimeError(
                f"no C++ compiler {_compiler()!r} to build {SOURCE}: set CXX"
            ) from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE} failed (exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the loader library, once a process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind_symbols(ctypes.CDLL(str(build_library())))
        return _lib


def _bind_symbols(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gmtpu_decoders.argtypes = []
    lib.gmtpu_decoders.restype = ctypes.c_int
    lib.gmtpu_read.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.gmtpu_read.restype = ctypes.c_void_p
    lib.gmtpu_volume_ndim.argtypes = [ctypes.c_void_p]
    lib.gmtpu_volume_ndim.restype = ctypes.c_int
    lib.gmtpu_volume_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gmtpu_volume_shape.restype = None
    lib.gmtpu_volume_data.argtypes = [ctypes.c_void_p]
    lib.gmtpu_volume_data.restype = ctypes.POINTER(ctypes.c_float)
    lib.gmtpu_volume_free.argtypes = [ctypes.c_void_p]
    lib.gmtpu_volume_free.restype = None
    lib.gmtpu_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gmtpu_loader_create.restype = ctypes.c_void_p
    lib.gmtpu_loader_next.argtypes = [ctypes.c_void_p]
    lib.gmtpu_loader_next.restype = ctypes.c_void_p
    lib.gmtpu_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.gmtpu_loader_destroy.restype = None
    return lib


def missing_decoder(paths: list[str]) -> str | None:
    """The header of the first decoder that `paths` need and the built
    library lacks, or None."""
    built = load_library().gmtpu_decoders()
    for bit, (header, _, _, exts) in enumerate(DECODERS):
        if not built & (1 << bit) and any(p.lower().endswith(exts) for p in paths):
            return header
    return None


def _check_decoders(paths: list[str]) -> None:
    header = missing_decoder(paths)
    if header is not None:
        raise RuntimeError(
            f"the data loader was built without the decoder these files need: {header} was "
            f"not found when it was built (install its development package and remove "
            f"{BUILD_DIR}/dataloader-*.so to rebuild)"
        )


def _volume_to_array(lib, handle) -> np.ndarray:
    ndim = lib.gmtpu_volume_ndim(handle)
    shape = (ctypes.c_int64 * ndim)()
    lib.gmtpu_volume_shape(handle, shape)
    shape = tuple(int(s) for s in shape)
    count = int(np.prod(shape))
    data_ptr = lib.gmtpu_volume_data(handle)
    arr = np.ctypeslib.as_array(data_ptr, shape=(count,)).reshape(shape).copy()
    lib.gmtpu_volume_free(handle)
    return arr


def _read_native(path: str, raw: bool = False) -> np.ndarray:
    lib = load_library()
    _check_decoders([path])
    err = ctypes.create_string_buffer(_ERR_LEN)
    handle = lib.gmtpu_read(path.encode(), int(raw), err, _ERR_LEN)
    if not handle:
        raise IOError(err.value.decode(errors="replace"))
    return _volume_to_array(lib, handle)


def read_nifti(path: str, native: bool = True) -> np.ndarray:
    """Read a .nii / .nii.gz volume into a float32 array (C order).

    The returned axis order is the reverse of the NIfTI on-disk (Fortran)
    dim order, i.e. (dimN, ..., dim1), matching C indexing of the buffer.
    """
    return _read_native(path) if native else _read_nifti_py(path)


def read_image(path: str, native: bool = True, raw: bool = False) -> np.ndarray:
    """Decode a PNG/JPEG to float32 ((H, W) or (H, W, C)), scaled to [0, 1]
    by the source bit depth (255 / 65535) unless `raw` (label maps keep
    their integer values). `native=False` decodes with PIL, as JAX's
    fallback does."""
    if native:
        return _read_native(path, raw)
    return _pil_decode(path, raw)


def _pil_decode(path: str, raw: bool = False) -> np.ndarray:
    """PIL decode: float32, scaled by the source dtype's range (np.iinfo for
    integer modes) unless `raw`."""
    from PIL import Image

    with Image.open(path) as im:
        data = np.asarray(im)
    arr = data.astype(np.float32)
    if not raw and np.issubdtype(data.dtype, np.integer):
        arr = arr / float(np.iinfo(data.dtype).max)
    return arr


def _read_nifti_py(path: str) -> np.ndarray:
    """Pure-python NIfTI-1 reader."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 348 or struct.unpack("<i", raw[:4])[0] != 348:
        raise IOError(f"not a NIfTI-1 file: {path}")
    dim = struct.unpack("<8h", raw[40:56])
    datatype, bitpix = struct.unpack("<2h", raw[70:74])
    vox_offset = struct.unpack("<f", raw[108:112])[0]
    scl_slope, scl_inter = struct.unpack("<2f", raw[112:120])
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])[::-1]
    dtypes = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
              256: np.int8, 512: np.uint16, 768: np.uint32}
    if datatype not in dtypes:
        raise IOError(f"unsupported NIfTI datatype {datatype}")
    offset = int(vox_offset) if vox_offset >= 348 else 352
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtypes[datatype], count=count, offset=offset)
    slope = scl_slope if scl_slope != 0 else 1.0
    return (data.astype(np.float32) * slope + scl_inter).reshape(shape)


def write_nifti(path: str, array: np.ndarray) -> None:
    """Write a float32 array as an (uncompressed) minimal NIfTI-1 file."""
    import struct

    array = np.asarray(array, np.float32)
    ndim = array.ndim
    dim = [ndim] + list(array.shape[::-1]) + [1] * (7 - ndim)
    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<2h", header, 70, 16, 32)  # float32, 32 bits
    struct.pack_into("<8f", header, 76, *([1.0] * 8))  # pixdim
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", header, 112, 1.0, 0.0)  # slope/inter
    header[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(b"\x00" * 4)  # extension flag
        f.write(array.tobytes())


class PrefetchLoader:
    """Multi-threaded prefetch loader over the native worker pool.

    Iterates float32 numpy arrays in the order of `paths`; IO,
    decompression and decoding run in C++ threads at most `max_queue` files
    ahead of the consumer. Workers dispatch per file by extension:
    .png/.jpg/.jpeg through the image decoders, everything else through the
    NIfTI reader. Unreadable files are skipped with a line on stderr, as
    the JAX loader skips them.
    """

    def __init__(self, paths: list[str], num_workers: int = 4, max_queue: int = 8,
                 loop: bool = False) -> None:
        self._handle = None
        if not paths:
            raise ValueError("PrefetchLoader needs at least one path")
        self._lib = load_library()
        _check_decoders(paths)
        self._paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._handle = self._lib.gmtpu_loader_create(
            self._paths, len(paths), num_workers, max_queue, int(loop)
        )
        self.loop = loop

    def __iter__(self):
        while self._handle:
            handle = self._lib.gmtpu_loader_next(self._handle)
            if not handle:
                return
            yield _volume_to_array(self._lib, handle)

    def close(self) -> None:
        if self._handle:
            self._lib.gmtpu_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


# the JAX package's historical name for the same loader
PrefetchNiftiLoader = PrefetchLoader
