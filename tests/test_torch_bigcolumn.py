"""giddy_tpu_torch's decode of columns past the single-call addressing
limit against giddy_tpu's, on the CPU, tolerance 0 (the counterpart of
tests/test_bigcolumn.py).

A real 2**31-value column needs more than 8 GiB of host memory, so both
packages' ``util.MAX_DEVICE_ELEMS`` is lowered to 4 groups: ``decode`` then
decodes in group chunks (partial.GroupSlicer) and returns a NumPy array,
padded or not, equal to the reference's chunked decode (interpret mode, in
a fresh process of this module's) and to the input; the single-call
guard of get_decoder and the scan guards still raise in both."""

import numpy as np
import pytest
import torch

import giddy_tpu_torch as gtt
from giddy_tpu_torch import aggregate, query, util
from giddy_tpu_torch.datagen import gen_column
from giddy_tpu_torch.util import GROUP

from test_torch_inputs import FreshProcess, rng_of

CPU = torch.device("cpu")
LIMIT = 4 * GROUP
N = 10 * GROUP + 321  # 11 padded groups, far past the lowered limit
SCHEMES = ["nbit", "delta", "rle", "dict", "dzbv", "patched", "wide"]
JAX = FreshProcess()


@pytest.fixture(autouse=True, scope="module")
def jax_process():
    yield
    JAX.close()


@pytest.fixture
def tiny_limit(monkeypatch):
    monkeypatch.setattr(util, "MAX_DEVICE_ELEMS", LIMIT)


def values(scheme: str) -> np.ndarray:
    rng = rng_of(f"bigcolumn/{scheme}")
    if scheme == "wide":
        return rng.integers(-(2**62), 2**62, N, dtype=np.int64)
    return gen_column(scheme, N, rng)


def ref_chunked(scheme: str) -> tuple[np.ndarray, np.ndarray]:
    """giddy_tpu.decode of the column, unpadded and padded, under the
    lowered limit."""
    import giddy_tpu as gt
    from giddy_tpu import util as jutil

    jutil.MAX_DEVICE_ELEMS = LIMIT
    col = gt.encode(values(scheme), scheme, name=f"big_{scheme}")
    out, padded = gt.decode(col), gt.decode(col, pad=True)
    assert isinstance(out, np.ndarray) and isinstance(padded, np.ndarray)
    return out, padded


def ref_guards() -> list[str]:
    """The messages the reference raises under the lowered limit: the
    single-call guard, a scan and an aggregate."""
    import giddy_tpu as gt
    from giddy_tpu import aggregate as jagg
    from giddy_tpu import query as jquery
    from giddy_tpu import util as jutil

    jutil.MAX_DEVICE_ELEMS = LIMIT
    col = gt.encode(values("nbit"), "nbit")
    out = []
    for fn in (gt.get_decoder, lambda c: jquery.count_where(c, "lt", 5), jagg.sum_, jagg.min_):
        try:
            fn(col)
            out.append("no error")
        except NotImplementedError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_auto_chunks(scheme, tiny_limit):
    v = values(scheme)
    col = gtt.encode(v, scheme, name=f"big_{scheme}")
    out, padded = gtt.decode(col, device=CPU), gtt.decode(col, device=CPU, pad=True)
    want, want_padded = JAX(ref_chunked, scheme)
    assert isinstance(out, np.ndarray) and isinstance(padded, np.ndarray)
    assert out.dtype == want.dtype and out.tobytes() == want.tobytes() == v.tobytes()
    assert padded.shape == (11 * GROUP,) and padded.tobytes() == want_padded.tobytes()


def test_decode_below_the_limit_stays_on_the_device(tiny_limit):
    v = gen_column("nbit", 3 * GROUP, rng_of("bigcolumn/small"))
    out = gtt.decode(gtt.encode(v, "nbit"), device=CPU)
    assert isinstance(out, torch.Tensor) and np.array_equal(out.numpy(), v)


GUARDS = ["get_decoder", "count_where", "sum_", "min_"]


@pytest.mark.parametrize("which", range(len(GUARDS)), ids=GUARDS)
def test_guards_still_raise(which, tiny_limit):
    col = gtt.encode(values("nbit"), "nbit")
    fn = (gtt.get_decoder, lambda c: query.count_where(c, "lt", 5, device=CPU),
          lambda c: aggregate.sum_(c, device=CPU), lambda c: aggregate.min_(c, device=CPU))[which]
    with pytest.raises(NotImplementedError, match="addressing limit") as e:
        fn(col)
    if not _GUARDS:
        _GUARDS.extend(JAX(ref_guards))
    assert str(e.value) == _GUARDS[which]


_GUARDS: list[str] = []
