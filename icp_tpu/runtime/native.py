"""ctypes bindings for the native host runtime (native/icp_host.cpp).

The reference's host layer is C++; this build keeps host-side IO and the
verification oracle native too. The library is built on demand with the
checked-in Makefile (g++ is in the image; pybind11 is not, hence ctypes).
Every entry point has a numpy fallback so the framework works without a
compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libicp_host.so"))

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.icp_read_cloud.restype = ctypes.c_long
    lib.icp_read_cloud.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_long]
    lib.icp_write_cloud.restype = ctypes.c_int
    lib.icp_write_cloud.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_long]
    lib.icp_validate_cloud.restype = ctypes.c_long
    lib.icp_validate_cloud.argtypes = [ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
    lib.icp_golden_nn.restype = None
    lib.icp_golden_nn.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_long,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_long, ctypes.c_float,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_float)]
    lib.icp_golden_solve.restype = None
    lib.icp_golden_solve.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_cloud(path: str, max_points: int = 640 * 480) -> np.ndarray:
    """Native mmap cloud read; numpy fallback."""
    lib = load()
    if lib is None:
        from icp_tpu.sensors.io import read_cloud_bin

        return read_cloud_bin(path)
    out = np.empty((max_points, 8), np.float32)
    n = lib.icp_read_cloud(path.encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"native read failed for {path}")
    return out[:n]


def write_cloud(path: str, cloud: np.ndarray) -> None:
    lib = load()
    arr = np.ascontiguousarray(cloud, np.float32)
    if lib is None:
        from icp_tpu.sensors.io import write_cloud_bin

        write_cloud_bin(path, arr)
        return
    if lib.icp_write_cloud(path.encode(), _fptr(arr), len(arr)) != 0:
        raise IOError(f"native write failed for {path}")


def validate_cloud(cloud: np.ndarray) -> int:
    """Count valid points; raises on non-finite data. Native or numpy."""
    arr = np.ascontiguousarray(cloud, np.float32)
    lib = load()
    if lib is None:
        if not np.isfinite(arr).all():
            raise ValueError("cloud contains non-finite values")
        return int((np.abs(arr[:, :3]).sum(1) > 0).sum())
    n = lib.icp_validate_cloud(_fptr(arr), len(arr))
    if n < 0:
        raise ValueError("cloud contains non-finite values")
    return int(n)


def golden_nn(queries: np.ndarray, db: np.ndarray, alpha: float):
    """Native exact-NN oracle (O(mn)); numpy fallback."""
    q = np.ascontiguousarray(queries, np.float32)
    d = np.ascontiguousarray(db, np.float32)
    lib = load()
    if lib is None:
        w = np.array([1, 1, 1, 0, alpha, alpha, alpha, 0], np.float32)
        d2 = (((q[:, None, :] - d[None, :, :]) ** 2) * w).sum(-1)
        return d2.argmin(1).astype(np.int32), d2.min(1).astype(np.float32)
    idx = np.empty((len(q),), np.int32)
    dist = np.empty((len(q),), np.float32)
    lib.icp_golden_nn(_fptr(q), len(q), _fptr(d), len(d),
                      ctypes.c_float(alpha),
                      idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                      _fptr(dist))
    return idx, dist


def golden_solve(moving: np.ndarray, fixed: np.ndarray, d2: np.ndarray,
                 weighted: bool = True, estimate_scale: bool = True,
                 c: float = 1e-6) -> np.ndarray:
    """Native golden Horn solve from matched pairs -> T[8] (reference
    layout [qx,qy,qz,qw, tx,ty,tz,sk])."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    mv = np.ascontiguousarray(moving, np.float32)
    fx = np.ascontiguousarray(fixed, np.float32)
    dd = np.ascontiguousarray(d2, np.float32)
    Tk = np.empty((8,), np.float32)
    lib.icp_golden_solve(_fptr(mv), _fptr(fx), _fptr(dd), len(mv),
                         int(weighted), int(estimate_scale),
                         ctypes.c_float(c), _fptr(Tk))
    return Tk
