"""Host utility layer of the PyTorch port (counterpart of giddy_tpu/util.py).

Plain NumPy. The port keeps its own copy because every module of
``giddy_tpu`` imports JAX through its package; the CPU tests hold the two
copies to identical results.
"""

from __future__ import annotations

import numpy as np

# Fundamental layout constants (FORMAT.md §0). Frozen by the format spec.
LANES = 1024  # interleave lanes C; lane c of a group is CUDA thread c
SLOTS = 32  # values per lane per group S
GROUP = LANES * SLOTS  # 32768 — the independently-decodable tile

U32 = np.uint32

_DTYPES = {
    "int32": np.int32,
    "uint32": np.uint32,
    "int64": np.int64,
    "uint64": np.uint64,
    "int16": np.int16,
    "uint16": np.uint16,
    "int8": np.int8,
    "uint8": np.uint8,
    # Floats ride as IEEE-754 bitpatterns through uint32 payloads.
    "float32": np.float32,
    "float64": np.float64,
}


def np_dtype(name: str) -> np.dtype:
    return np.dtype(_DTYPES[name])


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def bits_needed(max_value: int) -> int:
    """Smallest B with max_value < 2**B (B>=1); the NBit width chooser."""
    return max(1, int(max_value).bit_length())


def bytes_needed(max_value: int) -> int:
    return max(1, cdiv(bits_needed(max_value), 8))


def num_groups(n: int) -> int:
    return cdiv(max(n, 1), GROUP)


# A single device call addresses fewer than 2**31 padded values: the kernels
# take int32 positions, as in the reference (giddy_tpu/util.py
# MAX_DEVICE_ELEMS). Larger columns decode in group chunks (api.decode,
# partial, stream). Read at call time, so a test can lower it.
MAX_DEVICE_ELEMS = 2**31

NP_CMP = {
    "eq": np.equal, "ne": np.not_equal, "lt": np.less,
    "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
}


def check_device_addressable(n: int, what: str = "decode") -> None:
    # strict: n_pad == 2**31 itself is excluded — RLE padding sentinels sit
    # at n_pad and must stay representable (and sorted) as int32
    if num_groups(n) * GROUP >= MAX_DEVICE_ELEMS:
        raise NotImplementedError(
            f"{what} of {n} elements exceeds the 2**31 single-call device "
            "addressing limit (int32 positions); use partial.decode_groups "
            "or stream.stream_decode to process the column in group chunks"
        )


def sorted_factorize(values: np.ndarray):
    """(sorted_unique, codes) with np.unique(return_inverse=True) semantics.

    The reference prefers pandas' hash factorize when it is installed; both
    give the same sorted dictionary and codes, and pandas is not a
    dependency of the port. Object arrays (strings) factorize through a
    hash of their distinct values, which are then sorted: np.unique would
    sort every row with Python comparisons."""
    values = np.asarray(values)
    if values.dtype != object:
        return np.unique(values, return_inverse=True)
    rows = values.tolist()
    uniq = sorted(set(rows))
    index = {u: i for i, u in enumerate(uniq)}
    dic = np.empty(len(uniq), dtype=object)
    dic[:] = uniq
    return dic, np.fromiter(map(index.__getitem__, rows), np.intp, count=len(rows))


def pad_to_groups(v: np.ndarray, fill: int = 0) -> np.ndarray:
    """Pad a 1-D value array to a whole number of GROUPs (FORMAT.md §0)."""
    n = v.shape[0]
    n_pad = num_groups(n) * GROUP
    if n == n_pad:
        return np.ascontiguousarray(v)
    out = np.full(n_pad, fill, dtype=v.dtype)
    out[:n] = v
    return out


def dtype_to_u32(v: np.ndarray) -> np.ndarray:
    """Reinterpret a logical-dtype array as uint32 payloads (zero-extended).

    32-bit dtypes are bit-reinterpreted; narrower dtypes are zero-extended
    via their unsigned view. 64-bit columns are not LMP-packable directly.
    """
    dt = v.dtype
    if dt.itemsize == 4:
        return v.view(np.uint32)
    if dt.itemsize > 4:
        raise ValueError(f"{dt} too wide for 32-bit LMP packing")
    return v.view(np.dtype(f"uint{dt.itemsize * 8}")).astype(np.uint32)


def u32_to_dtype(u: np.ndarray, dtype_name: str) -> np.ndarray:
    """Inverse of :func:`dtype_to_u32`: uint32 payloads -> logical dtype."""
    dt = np_dtype(dtype_name)
    if dt.itemsize == 4:
        return u.view(dt)
    if dt.itemsize > 4:
        raise ValueError(f"{dt} too wide for 32-bit LMP payloads")
    return u.astype(np.dtype(f"uint{dt.itemsize * 8}")).view(dt)


def zigzag(d: np.ndarray) -> np.ndarray:
    """Signed int32 -> unsigned zigzag (FORMAT.md §0.2)."""
    d = d.astype(np.int32, copy=False)
    if d.ndim == 1:
        from . import native

        nat = native.zigzag(d)
        if nat is not None:
            return nat
    return ((d.astype(np.uint32) << U32(1)) ^ (d >> 31).astype(np.uint32)).astype(
        np.uint32
    )


def unzigzag(z: np.ndarray) -> np.ndarray:
    """Unsigned zigzag -> signed int32 (FORMAT.md §0.2)."""
    z = z.astype(np.uint32, copy=False)
    if z.ndim == 1:
        from . import native

        nat = native.unzigzag(z)
        if nat is not None:
            return nat
    return ((z >> U32(1)) ^ (-(z & U32(1)).astype(np.int32)).astype(np.uint32)).astype(
        np.int32
    )
