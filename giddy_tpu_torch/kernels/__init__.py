"""Device decoders, scan kernels and device encode of the PyTorch port:
one wrapper per CUDA kernel.

Importing this package installs a device decoder for every ported scheme
(import = registration, as in giddy_tpu.kernels). The kernels themselves
live in ``giddy_tpu_torch/csrc`` and are built at first launch.
"""

from .. import ref as _ref  # noqa: F401  (host codecs must register first)
from . import agg, alp, bitmap, cascade, cumsum, delta, delta2, dict_, dzbv, encode, filter_, for_, model, nbit, patch, raw, rle, run_filter, xordelta  # noqa: F401  (import = registration)

# Every kernel of the decode path, of the scan layer (filter_fold K16,
# agg_fold K17, run_filter K19) and of device encode (lmp_pack K18) -> the module of its
# wrapper (which holds the wrapper under the kernel's name and
# ``LAUNCHES``, or, for dzbv's three kernels, ``LAUNCHES[name]``). cascade_lut is the fused dictionary stage of K1-K7;
# its launches are counted both there and by the inner kernel's wrapper.
WRAPPERS = {
    "lmp_unpack": nbit, "for_unpack": for_, "delta_decode": delta, "dict_decode": dict_,
    "run_expand": rle, "cumsum_rows": cumsum, "delta2_decode": delta2, "xordelta_decode": xordelta,
    "patched_decode": patch, "cascade_lut": cascade,
    "model_decode": model, "bitmap_decode": bitmap, "alp_decode": alp,
    "dzbv_tile_decode": dzbv, "dzbv_group_decode": dzbv, "dzbv_plane_decode": dzbv,
    "filter_fold": filter_, "agg_fold": agg, "lmp_pack": encode, "run_filter": run_filter,
}
# Schemes that one kernel decodes; rle and rpe take K5 or K6 and dzbv K13,
# K14 or K15 by stream form, cascade its inner scheme's kernel with the table.
_BY_SCHEME = {
    "nbit": "lmp_unpack", "dzbf": "lmp_unpack", "for": "for_unpack",
    "delta": "delta_decode", "dict": "dict_decode",
    "delta2": "delta2_decode", "xordelta": "xordelta_decode", "patched": "patched_decode",
    "model": "model_decode", "bitmap": "bitmap_decode", "alp": "alp_decode",
}


def kernel_call(col, streams: dict, out_store) -> tuple:
    """(kernel name, wrapper arguments) of the one kernel that decodes
    ``col`` from its prepped device streams (the compressed patched kind
    decodes its positions with K3 first)."""
    if col.scheme in ("rle", "rpe"):
        return rle.kernel_call(col, streams, out_store)
    if col.scheme == "dzbv":
        return dzbv.kernel_call(col, streams, out_store)
    if col.scheme == "cascade":
        return cascade.kernel_call(col, streams, out_store)
    name = _BY_SCHEME[col.scheme]
    return name, WRAPPERS[name].args(col, streams, out_store)


def reset_launches() -> None:
    for name, mod in WRAPPERS.items():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES[name] = 0
        else:
            mod.LAUNCHES = 0
    rle.FORM_LAUNCHES.update(dict.fromkeys(rle.FORM_LAUNCHES, 0))


def launches() -> dict[str, int]:
    return {name: mod.LAUNCHES[name] if isinstance(mod.LAUNCHES, dict) else mod.LAUNCHES
            for name, mod in WRAPPERS.items()}


def form_launches() -> dict[str, int]:
    """K5's launches by form (rle.FORM_LAUNCHES): "chain" and "rank"."""
    return dict(rle.FORM_LAUNCHES)
