"""giddy_tpu_torch's C++ host codec (native.py, csrc/host_lmp.cpp) against
the port's NumPy path and the reference's own C++ codec (giddy_tpu.native):
LMP pack and unpack at every width, the dzbv byte-plane split, zigzag, the
encoders with ``GIDDY_TPU_NO_NATIVE=1``, and the build (into ``_build/``,
and by two processes at once). Tests that need the library skip where g++
cannot build it, as tests/test_native.py does."""

import concurrent.futures
import ctypes
import multiprocessing
import os
import pathlib
import time

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu import native as gt_native
import giddy_tpu_torch as gtt
from giddy_tpu_torch import native, util
from giddy_tpu_torch.datagen import CORE_SCHEMES, gen_column
from giddy_tpu_torch.ref import dzbv as ref_dzbv
from giddy_tpu_torch.ref import lmp as ref_lmp
from giddy_tpu_torch.util import GROUP, num_groups

from test_torch_inputs import FreshProcess, assert_same_column, rng_of, wrapping_walk

# Ragged, below and above the 2^21 values (64 groups) from which the
# library's loops run on its thread pool.
SIZES = [3 * GROUP + 77, 64 * GROUP + 77]


@pytest.fixture
def lib():
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain: the port's host codec is not built")
    return native.get_lib()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", range(1, 33))
def test_pack_unpack_match_numpy_and_reference(lib, bits, n):
    rng = rng_of(f"native/pack/{bits}/{n}")
    v = rng.integers(0, 2**bits, n, dtype=np.uint64).astype(np.uint32)
    v[:2] = [0, 2**bits - 1]
    ng = num_groups(n)
    padded = util.pad_to_groups(v)
    nat = native.lmp_pack(padded, bits, ng)
    with native.numpy_only():
        want = ref_lmp.lmp_pack(v, bits)
        back_np = ref_lmp.lmp_unpack(want, bits, n)
    assert nat.dtype == np.uint32 and nat.shape == (ng, bits * 1024)
    assert nat.tobytes() == want.tobytes() == gt_native.lmp_pack(padded, bits, ng).tobytes()
    assert ref_lmp.lmp_pack(v, bits).tobytes() == want.tobytes()  # through the caller, native
    back = ref_lmp.lmp_unpack(nat, bits, n)
    assert back.tobytes() == back_np.tobytes() == v.tobytes()
    assert native.lmp_unpack(nat, bits, ng).tobytes() == gt_native.lmp_unpack(nat, bits, ng).tobytes()
    # slices and int32 words, as the dzbv prep and the bitmap readers pass them
    assert ref_lmp.lmp_unpack(np.vstack([nat, nat])[:ng].view(np.int32), bits, n).tobytes() == v.tobytes()


def test_pack_and_unpack_refuse_a_wrong_size(lib):
    with pytest.raises(ValueError, match="values"):
        native.lmp_pack(np.zeros(GROUP - 1, np.uint32), 4, 1)
    with pytest.raises(ValueError, match="words"):
        native.lmp_unpack(np.zeros((2, 4 * 1024), np.uint32), 4, 1)
    with pytest.raises(ValueError, match="out of range"):
        ref_lmp.lmp_pack(np.array([16], np.uint32), 4)


@pytest.mark.parametrize("n", [0, 1, GROUP, (1 << 16) * 3 + 12345, (1 << 21) + 12345])
def test_dzbv_split_matches_numpy_and_reference(lib, n):
    """Every width boundary, at counts that are and are not a multiple of
    the C++ fill's 2^16 chunk, serial and on the thread pool."""
    rng = rng_of(f"native/dzbv/{n}")
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[rng.random(n) < 0.5] &= 0xFF
    u[rng.random(n) < 0.3] &= 0xFFFF
    edges = np.array([0, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFF, 0x1000000, 0xFFFFFFFF], np.uint32)
    u[: min(n, edges.shape[0])] = edges[: min(n, edges.shape[0])]
    wm1, planes = native.dzbv_split(u)
    with native.numpy_only():
        want_w, want_p = ref_dzbv.split(u)
    ref_w, ref_p = gt_native.dzbv_split(u)
    assert wm1.tobytes() == want_w.tobytes() == ref_w.tobytes()
    assert len(planes) == 4
    for k in range(4):
        assert planes[k].dtype == np.uint32
        assert planes[k].tobytes() == want_p[k].tobytes() == ref_p[k].tobytes(), f"plane{k}"


@pytest.mark.parametrize("n", [100_003, (1 << 21) + 3])
def test_zigzag_at_the_int32_ends(lib, n):
    d = wrapping_walk(n, rng_of(f"native/zigzag/{n}"))
    d[:5] = [0, -1, 1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    z = util.zigzag(d)
    with native.numpy_only():
        z_np = util.zigzag(d)
        d_np = util.unzigzag(z_np)
    assert z.dtype == np.uint32 and z.tobytes() == z_np.tobytes() == gt_native.zigzag(d).tobytes()
    assert z[3] == 0xFFFFFFFF and z[4] == 0xFFFFFFFE
    back = util.unzigzag(z)
    assert back.dtype == np.int32 and back.tobytes() == d_np.tobytes() == d.tobytes()
    # 2-D input takes the NumPy path
    assert util.zigzag(d[:100].reshape(10, 10)).tobytes() == z[:100].tobytes()


def test_path_flags_and_numpy_only(lib):
    assert native.path() == "native" and native.flags()[0] == "-O3"
    assert "-march=native" not in native.flags()
    with native.numpy_only():
        assert native.path() == "numpy" and native.flags() is None
        assert native.lmp_pack(np.zeros(GROUP, np.uint32), 1, 1) is None
    assert native.path() == "native"


def test_library_lands_in_build(lib):
    where = native.library_path(native.flags())
    assert where.parent == native.BUILD_DIR == pathlib.Path(gtt.__file__).parent / "_build"
    assert where.exists() and where.name.startswith("libgiddy_host_")
    # the CUDA build takes csrc/*.cu only, never this source
    from giddy_tpu_torch.kernels import _build

    assert native.SOURCE.suffix == ".cpp" and native.SOURCE not in _build._sources()


def _encoded_streams(scheme: str) -> tuple[str, dict, dict, dict]:
    """(native.path(), params, streams as bytes, dtype/shape) of a core
    scheme's column, in this process."""
    v = gen_column(scheme, 2 * GROUP + 999, rng_of(f"native/encode/{scheme}"))
    col = gtt.encode(v, scheme, name="c")
    return (native.path(), col.params, {k: s.tobytes() for k, s in col.streams.items()},
            {k: (str(s.dtype), s.shape) for k, s in col.streams.items()})


@pytest.fixture(scope="module")
def no_native_process():
    """A spawned process that starts with GIDDY_TPU_NO_NATIVE=1."""
    before = os.environ.get("GIDDY_TPU_NO_NATIVE")
    os.environ["GIDDY_TPU_NO_NATIVE"] = "1"
    process = FreshProcess()
    try:
        process(time.sleep, 0)  # spawned while the variable is set
    finally:
        if before is None:
            del os.environ["GIDDY_TPU_NO_NATIVE"]
        else:
            os.environ["GIDDY_TPU_NO_NATIVE"] = before
    yield process
    process.close()


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_no_native_gives_the_same_containers(lib, no_native_process, scheme):
    path, params, streams, shapes = no_native_process(_encoded_streams, scheme)
    assert path == "numpy"
    here = _encoded_streams(scheme)
    assert here[0] == "native"
    assert (params, streams, shapes) == here[1:]
    v = gen_column(scheme, 2 * GROUP + 999, rng_of(f"native/encode/{scheme}"))
    assert_same_column(gtt.encode(v, scheme, name="c"), gt.encode(v, scheme, name="c"))


def _build_when_both_ready(build_dir: str, me: int) -> str:
    """Wait (up to 60 s) until both processes are up, then build."""
    d = pathlib.Path(build_dir)
    (d / f"ready.{me}").touch()
    deadline = time.monotonic() + 60
    while len(list(d.glob("ready.*"))) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    built = native.build(d / "_build")
    return str(built[0])


def test_two_processes_build_at_once(lib, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        futures = [pool.submit(_build_when_both_ready, str(tmp_path), i) for i in range(2)]
        paths = {f.result(timeout=120) for f in futures}
    assert len(paths) == 1
    files = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert files == [pathlib.Path(paths.pop()).name]  # no temporary left behind
    loaded = native._load(tmp_path / "_build" / files[0])
    v = np.arange(GROUP, dtype=np.uint32) % 8
    words = np.empty((1, 3 * 1024), np.uint32)
    loaded.lmp_pack_u32(v, words, 1, 3)
    with native.numpy_only():
        assert words.tobytes() == ref_lmp.lmp_pack(v, 3).tobytes()
    assert isinstance(loaded, ctypes.CDLL)
