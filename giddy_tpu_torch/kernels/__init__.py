"""Device decoders of the PyTorch port: one wrapper per CUDA kernel.

Importing this package installs a device decoder for every ported scheme
(import = registration, as in giddy_tpu.kernels). The kernels themselves
live in ``giddy_tpu_torch/csrc`` and are built at first launch.
"""

from .. import ref as _ref  # noqa: F401  (host codecs must register first)
from . import delta, dict_, for_, nbit  # noqa: F401  (import = registration)

# Every kernel of the decode path -> the module of its wrapper (which
# holds the wrapper under the kernel's name, ``args`` and ``LAUNCHES``).
WRAPPERS = {"lmp_unpack": nbit, "for_unpack": for_, "delta_decode": delta, "dict_decode": dict_}
_BY_SCHEME = {
    "nbit": "lmp_unpack", "dzbf": "lmp_unpack", "for": "for_unpack",
    "delta": "delta_decode", "dict": "dict_decode",
}


def kernel_call(col, streams: dict, out_store) -> tuple:
    """(kernel name, wrapper arguments) of the one kernel that decodes
    ``col`` from its prepped device streams."""
    name = _BY_SCHEME[col.scheme]
    return name, WRAPPERS[name].args(col, streams, out_store)


def reset_launches() -> None:
    for mod in WRAPPERS.values():
        mod.LAUNCHES = 0


def launches() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in WRAPPERS.items()}
