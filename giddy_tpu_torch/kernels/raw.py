"""Identity scheme — device decoder (counterpart of giddy_tpu/kernels/raw.py).

No kernel, as in the reference: the uploaded ``data`` stream is the
payload. It stores no narrow width; ``api`` cuts a narrow column after.
"""

from __future__ import annotations

import torch

from .. import registry
from ..format import EncodedColumn


def build(col: EncodedColumn, out_store: torch.dtype = torch.int32):
    return lambda streams: streams["data"].reshape(-1)


registry.register_device("raw", build)
