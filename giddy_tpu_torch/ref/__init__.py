"""Host codecs of the PyTorch port (NumPy): encode and the oracle decode.

One module per scheme of the ported slices, mirroring giddy_tpu/ref/. Each
provides ``encode(values, ...) -> EncodedColumn`` and ``decode(col) ->
np.ndarray`` and registers both with :mod:`giddy_tpu_torch.registry`. The
CPU tests hold them byte for byte to the JAX package's codecs.
"""

from . import alp, bitmap, cascade, delta, delta2, dict_, dzbf, dzbv, for_, model, nbit, patch, raw, rle, rpe, xordelta  # noqa: F401  (import = registration)
