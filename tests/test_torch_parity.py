"""The port against giddy_tpu's public surface, read from source alone.

For every module of giddy_tpu/, every public top-level name (a function,
class or assignment whose name has no leading underscore, ``__version__``,
and in ``__init__.py`` the names it re-exports) has one of three things: a
name of its own in the port module at the same relative path, an entry in
RENAMED, or an entry in NOT_PORTED with a one-line reason that points at
the port code taking its place. Every parameter of a public function, and
of a public class's public methods, exists in its counterpart under the
same renames, and the two command lines have the same subcommands. Every
script of the repo (each ``*.py`` at its root, in examples/ and in
scripts/) is the port's own, has a ``<name>_torch.py`` beside it whose
``main`` takes every parameter of the reference's and whose argparse
takes every ``--option`` of the reference's (or the option stands in
SCRIPTS_NOT_PORTED as ``"<script> --option"``), or stands in
SCRIPTS_NOT_PORTED with a one-line reason.

Both packages and the scripts are parsed with ``ast``, never imported, so
the check costs well under a second and brings no JAX into the worker.
NOT_PORTED and SCRIPTS_NOT_PORTED are mirrored in ROADMAP.md's "Do not
port" list."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "giddy_tpu", ROOT / "giddy_tpu_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

# module -> {reference name: the port's name}. A parameter is written
# "function(param)" or "Class.method(param)".
RENAMED = {
    "roofline.py": {f"{fn}(device_kind)": "device_name"
                    for fn in ("chip_bw", "column_roofline", "ops_budget", "ops_audit")},
    "kernels/lanes.py": {"unpack_lanes(x)": "packed", "group_cumsum(x)": "d"},
}

_LANES_SCAN = "the TPU's byte-plane MXU and pltpu.roll scans; the port scans a group in block_row_scan " \
              "(giddy_tpu_torch/csrc/lmp.cuh), plain versions in giddy_tpu_torch/kernels/lanes.py"
_VMEM_SPECS = "Pallas memory spaces and BlockSpecs; the port's kernels address global and shared memory " \
              "themselves (giddy_tpu_torch/csrc/lmp.cuh)"
_NARROW = "the TPU's 3D narrow-store geometry; a port kernel stores its out_dtype directly " \
          "(giddy_tpu_torch/kernels/_wrap.py T_NAME)"
_PLAN = "the TPU's VMEM grid plan; every port kernel runs one block a GROUP, so the grid is the " \
        "group count (giddy_tpu_torch/registry.py)"
_TPU_RATES = "TPU v5e issue rates; the card's are SM_CLOCK, PER_SM_CLOCK and chip_rates " \
             "(giddy_tpu_torch/roofline.py)"

# module -> {reference name, or "function(param)": why the port has none}
NOT_PORTED = {
    "__init__.py": {"plan": "registry.plan's re-export: " + _PLAN},
    "groupby.py": {
        "CHUNK_GROUPS": "the reference sums uint32 byte planes 256 groups a chunk so none wraps; the port "
                        "sums each value as an int64 (giddy_tpu_torch/groupby.py, its docstring's Exactness)",
    },
    "kernels/common.py": {
        "use_interpret": "Pallas interpret mode; a port wrapper runs its plain version when its tensor is on "
                         "the CPU (giddy_tpu_torch/kernels/nbit.py)",
        "force_compiled_trace": "forces a Mosaic trace under interpret mode; the port's kernels are built by "
                                "nvcc (giddy_tpu_torch/kernels/_build.py)",
        "vmem": _VMEM_SPECS,
        "block_spec": _VMEM_SPECS,
        "smem_spec": _VMEM_SPECS,
        "store": _NARROW,
        "narrow_geom": _NARROW,
        "resolve_narrow": _NARROW,
        "row_blocked_call": "the TPU's row-blocked pallas_call; a port kernel runs one block a GROUP "
                            "(giddy_tpu_torch/kernels/_wrap.py launch)",
        "to_device_streams": "host streams to jax arrays; the port's api.upload and api.device_streams "
                             "(giddy_tpu_torch/api.py)",
    },
    "kernels/dict_.py": {
        "DICT_PALLAS_MAX": "the VMEM limit of the fused dictionary gather; the port picks shared or global "
                           "memory with dict_in_shared (giddy_tpu_torch/kernels/dict_.py)",
        "use_lut": "the VMEM limit of the fused dictionary gather; the port picks shared or global memory "
                   "with dict_in_shared (giddy_tpu_torch/kernels/dict_.py)",
    },
    "kernels/encode.py": {
        "pack_lanes_to": "the Pallas kernel's in-VMEM pack; K18 lmp_pack_kernel "
                         "(giddy_tpu_torch/csrc/encode.cu), plain version lanes.pack_lanes",
    },
    "kernels/lanes.py": {
        "scan_mode": "the GIDDY_TPU_SCAN A/B switch; " + _LANES_SCAN,
        "xor_mode": "the GIDDY_TPU_XOR A/B switch; K8 xordelta_decode_kernel (giddy_tpu_torch/csrc/run_decode.cu)",
        "unpack_slot": "an in-kernel VMEM unpack; unpack_store_lane (giddy_tpu_torch/csrc/lmp.cuh)",
        "unpack_to": "an in-kernel VMEM unpack; unpack_store_lane (giddy_tpu_torch/csrc/lmp.cuh)",
        "unpack_map_to": "an in-kernel VMEM unpack; unpack_store_lane (giddy_tpu_torch/csrc/lmp.cuh)",
        "unpack_fold": "an in-kernel VMEM unpack; the scan kernels' gt::SmemLaneReader "
                       "(giddy_tpu_torch/csrc/lmp.cuh)",
        "LUT_LANE": "the 128-lane gather window; the gt::Lut stage (giddy_tpu_torch/csrc/lmp.cuh)",
        "gather_lut": "the 128-lane gather window; the gt::Lut stage (giddy_tpu_torch/csrc/lmp.cuh)",
        "expand_monotone": "the pltpu.roll run expansion; K5 run_strip_kernel (giddy_tpu_torch/csrc/run_decode.cu)",
        "SCAN_TILE": _LANES_SCAN,
        "tile_cumsum": _LANES_SCAN,
        "scan_scratch_bytes": _LANES_SCAN,
        "signed_cumsum": _LANES_SCAN,
        "signed_double_cumsum": _LANES_SCAN,
        "group_cumsum(byte_planes)": _LANES_SCAN,
        "group_cumsum(small)": _LANES_SCAN,
        "XOR_MXU_MAX": "the MXU parity scan's width limit; K8 xordelta_decode_kernel "
                       "(giddy_tpu_torch/csrc/run_decode.cu)",
        "group_cumxor": "the MXU parity scan; K8 xordelta_decode_kernel (giddy_tpu_torch/csrc/run_decode.cu)",
        "linear_iota": "a Mosaic iota in linear order; a port kernel reads threadIdx "
                       "(giddy_tpu_torch/csrc/lmp.cuh)",
    },
    "kernels/rle.py": {
        "build_rle": "one build function serves rle and rpe, its prep reads the positions "
                     "(giddy_tpu_torch/kernels/rle.py build)",
        "build_rpe": "one build function serves rle and rpe, its prep reads the positions "
                     "(giddy_tpu_torch/kernels/rle.py build)",
    },
    "ref/lmp.py": {
        "lmp_num_words": "no caller in giddy_tpu; the port writes num_groups(n) * bits * LANES where it sizes "
                         "words (giddy_tpu_torch/native.py)",
    },
    "registry.py": {"Plan": _PLAN, "plan": _PLAN},
    "roofline.py": {name: _TPU_RATES for name in ("VPU_LANES", "VPU_ALU_SLOTS", "CHIP_CLOCK_HZ", "MXU_INT8_MACS")},
    "util.py": {
        "WORD_BITS": "no caller in giddy_tpu; the port writes 32 (giddy_tpu_torch/util.py)",
        "I32": "no caller in giddy_tpu; the port writes np.int32 (giddy_tpu_torch/util.py)",
        "is_power_of_2": "no caller in giddy_tpu but ilog2; the port's next_power_of_2 "
                         "(giddy_tpu_torch/util.py)",
        "ilog2": "no caller in giddy_tpu; the port's next_power_of_2 (giddy_tpu_torch/util.py)",
    },
}

# The repo's scripts: each *.py in these directories (relative to the root).
SCRIPT_DIRS = (".", "examples", "scripts")
# The port's own scripts, beside every "*_torch.py".
PORT_SCRIPTS = {"chip_smoke.py"}
_CENSUS = "measures the reference's Mosaic or XLA path; the port measures with SASS censuses (ROADMAP \"Do not port\")"
_SCAN_AB = "A/Bs the reference's MXU and pltpu.roll scans, which the port does not have (ROADMAP \"Do not port\")"
# script -> why the port has no "<name>_torch.py" beside it; "<script> --option"
# -> why its "_torch.py" takes no such option
SCRIPTS_NOT_PORTED = {
    "bench.py --scan-ab": _SCAN_AB,
    "bench.py --ab-trials": "the trial count of --scan-ab, which " + _SCAN_AB,
    "__graft_entry__.py": "the TPU entry points: a compile check and a multichip dry run; chip_smoke.py takes its place",
    "scripts/regime_census.py": "the reference's ops census over regimes; " + _CENSUS,
    "scripts/bitmap_census.py": "the reference's bitmap plane-count census; " + _CENSUS,
    "scripts/dict_ab.py": "the A/B of the reference's VMEM dictionary gather; " + _CENSUS,
    "scripts/pinned_scaling.py": "CPU-core pinning for the reference's virtual mesh (ROADMAP \"Do not port\")",
}


def params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__version__"


def surface(source: str, init: bool = False) -> dict:
    """Public top-level name -> its parameters (a function), {method: its
    parameters} (a class) or None (anything else)."""
    out = {}

    def visit(body) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[node.name] = params(node)
            elif isinstance(node, ast.ClassDef):
                out[node.name] = {b.name: params(b) for b in node.body
                                  if isinstance(b, ast.FunctionDef) and (_public(b.name) or b.name == "__init__")}
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for target in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    out.update((n.id, None) for n in ast.walk(target) if isinstance(n, ast.Name))
            elif isinstance(node, ast.ImportFrom) and init and node.level:
                out.update((a.asname or a.name, None) for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)

    visit(ast.parse(source).body)
    return {k: v for k, v in out.items() if _public(k)}


def gaps(ref_source: str, port_source: str, renamed: dict, not_ported: dict, init: bool = False) -> list[str]:
    """What of the reference's surface the port neither has nor accounts
    for, and every map entry that no longer names a gap."""
    ref, port = surface(ref_source, init), surface(port_source, init)
    out, used = [], set()

    def counterpart(key: str, name: str) -> str:
        if key in renamed:
            used.add(key)
            return renamed[key]
        return name

    def accounted(key: str) -> bool:
        if key in not_ported:
            used.add(key)
            return True
        return False

    def same_params(qual: str, want: list[str], have: list[str]) -> None:
        for p in want:
            key = f"{qual}({p})"
            if counterpart(key, p) not in have and not accounted(key):
                out.append(f"parameter {key} has no counterpart")

    for name, what in ref.items():
        other = counterpart(name, name)
        if other not in port:
            if not accounted(name):
                out.append(f"{name} has no counterpart")
            continue
        if accounted(name):
            out.append(f"{name} is in NOT_PORTED but the port has it")
        theirs = port[other]
        if isinstance(what, list) and isinstance(theirs, list):
            same_params(name, what, theirs)
        elif isinstance(what, dict) and isinstance(theirs, dict):
            for method, ps in what.items():
                qual = f"{name}.{method}"
                if method not in theirs:
                    if not accounted(qual):
                        out.append(f"method {qual} has no counterpart")
                else:
                    same_params(qual, ps, theirs[method])
    out += [f"stale entry {key}" for key in sorted((set(renamed) | set(not_ported)) - used)]
    return out


def subcommands(source: str) -> set[str]:
    return {node.args[0].value for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_parser" and node.args and isinstance(node.args[0], ast.Constant)}


def options(source: str) -> list[str]:
    """The ``--options`` that ``source`` passes to ``add_argument``."""
    return [node.args[0].value for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_argument" and node.args and isinstance(node.args[0], ast.Constant)
            and str(node.args[0].value).startswith("--")]


def script_gaps(scripts: dict[str, str], not_ported: dict) -> list[str]:
    """What of the repo's scripts (relative path -> source) is neither the
    port's own, nor has a ``_torch`` counterpart whose ``main`` takes every
    parameter of the reference's and whose argparse every option, nor an
    entry in ``not_ported``; and every entry that no longer names such a
    script or option."""
    out, used = [], set()
    for path, source in sorted(scripts.items()):
        if path in PORT_SCRIPTS or path.endswith("_torch.py"):
            continue
        twin = path[: -len(".py")] + "_torch.py"
        if twin not in scripts:
            if path in not_ported:
                used.add(path)
            else:
                out.append(f"{path} has no counterpart")
            continue
        if path in not_ported:
            used.add(path)
            out.append(f"{path} is in SCRIPTS_NOT_PORTED but has {twin}")
        mains = [surface(text).get("main") for text in (source, scripts[twin])]
        out += [f"parameter {path} main({p}) has no counterpart in {twin}"
                for p in mains[0] or [] if p not in (mains[1] or [])]
        for option in options(source):
            if option in options(scripts[twin]):
                continue
            if f"{path} {option}" in not_ported:
                used.add(f"{path} {option}")
            else:
                out.append(f"option {path} {option} has no counterpart in {twin}")
    out += [f"stale entry {key}" for key in sorted(set(not_ported) - used)]
    return out


def repo_scripts() -> dict[str, str]:
    return {str((ROOT / d / p.name).relative_to(ROOT)): p.read_text()
            for d in SCRIPT_DIRS for p in sorted((ROOT / d).glob("*.py"))}


@pytest.mark.parametrize("module", MODULES)
def test_module_has_the_reference_surface(module):
    """A module the port has no file for (kernels/common.py) must account
    for each of its names in NOT_PORTED."""
    port = PORT / module
    found = gaps((REF / module).read_text(), port.read_text() if port.is_file() else "", RENAMED.get(module, {}),
                 NOT_PORTED.get(module, {}), init=port.name == "__init__.py")
    assert not found, found


def test_cli_subcommands_match():
    ref, port = (subcommands((p / "cli.py").read_text()) for p in (REF, PORT))
    assert "bench" in ref and ref == port


def test_every_script_is_ported_or_accounted_for():
    """Each script at the root, in examples/ and in scripts/: the port's
    own, ported beside itself, or in SCRIPTS_NOT_PORTED."""
    scripts = repo_scripts()
    assert {"examples/compression_tour_torch.py", "examples/tpch_demo_torch.py", "bench_torch.py",
            "scripts/multihost_bench_torch.py"} <= set(scripts)
    found = script_gaps(scripts, SCRIPTS_NOT_PORTED)
    assert not found, found


def test_every_entry_names_a_module_and_a_port_file():
    """The maps are keyed by modules of giddy_tpu, and every reason names
    a file of the port (or the ROADMAP item it waits on) that exists."""
    assert set(RENAMED) | set(NOT_PORTED) <= set(MODULES)
    for module, entries in NOT_PORTED.items():
        for name, reason in entries.items():
            files = [w.strip("(),") for w in reason.split() if w.startswith(("giddy_tpu_torch/", "(giddy_tpu_torch/"))]
            assert files or "ROADMAP item" in reason, (module, name)
            assert all((ROOT / f).exists() for f in files), (module, name, files)


REFERENCE = '''
"""a reference module"""
import numpy as np
from .util import GROUP

WIDTH = 8
_PRIVATE = 1


def decode(col, device_kind=None, *, pad=False):
    return col


class Reader:
    def __init__(self, path):
        self.path = path

    def read(self, n, offset=0):
        return n

    def _seek(self, where):
        pass
'''

PLANTS = {
    "function": (REFERENCE + "\n\ndef planted(col):\n    return col\n", "planted has no counterpart"),
    "constant": (REFERENCE + "\nPLANTED = 3\n", "PLANTED has no counterpart"),
    "class": (REFERENCE + "\n\nclass Planted:\n    pass\n", "Planted has no counterpart"),
    "parameter": (REFERENCE.replace("pad=False", "pad=False, planted=1"), "parameter decode(planted) has no counterpart"),
    "method": (REFERENCE.replace("def _seek", "def planted"), "method Reader.planted has no counterpart"),
    "method parameter": (REFERENCE.replace("offset=0", "offset=0, planted=2"),
                         "parameter Reader.read(planted) has no counterpart"),
}


def test_checker_passes_an_equal_surface():
    port = REFERENCE.replace("device_kind", "device_name") + "\n\ndef extra():\n    pass\n"
    renamed = {"decode(device_kind)": "device_name"}
    assert gaps(REFERENCE, port, renamed, {}) == []
    assert gaps(REFERENCE, port, {}, {}) == ["parameter decode(device_kind) has no counterpart"]


@pytest.mark.parametrize("plant", list(PLANTS))
def test_checker_catches_a_planted_public_name(plant):
    """A public name added to the reference with no counterpart fails the
    check, and an entry in either map accounts for it; an entry that names
    nothing missing is stale."""
    ref, want = PLANTS[plant]
    assert gaps(ref, REFERENCE, {}, {}) == [want]
    key = want.split(" ")[-4] if want.startswith(("parameter", "method")) else want.split(" ")[0]
    assert gaps(ref, REFERENCE, {}, {key: "planted in this test"}) == []
    assert gaps(REFERENCE, REFERENCE, {}, {key: "planted in this test"}) == [f"stale entry {key}"]


def test_checker_refuses_a_not_ported_name_that_the_port_has():
    assert gaps(REFERENCE, REFERENCE, {}, {"WIDTH": "x"}) == ["WIDTH is in NOT_PORTED but the port has it"]


SCRIPT = "def main(n: int = 1, *, out=None):\n    ap.add_argument('--n', type=int)\n"
SCRIPT_PLANTS = {
    "script": ({"examples/planted.py": SCRIPT}, "examples/planted.py has no counterpart"),
    "main parameter": ({"examples/planted.py": SCRIPT, "examples/planted_torch.py": SCRIPT.replace(", *, out=None", "")},
                       "parameter examples/planted.py main(out) has no counterpart in examples/planted_torch.py"),
    "option": ({"examples/planted.py": SCRIPT + "    ap.add_argument('--planted', action='store_true')\n",
                "examples/planted_torch.py": SCRIPT},
               "option examples/planted.py --planted has no counterpart in examples/planted_torch.py"),
}


def test_script_checker_passes_ported_and_own_scripts():
    twin = SCRIPT.replace("out=None", "out=None, device='cuda'")
    scripts = {"examples/demo.py": SCRIPT, "examples/demo_torch.py": twin, "scripts/probe_torch.py": "",
               "chip_smoke.py": "", "bench.py": SCRIPT}
    assert script_gaps(scripts, {"bench.py": "planted in this test"}) == []


@pytest.mark.parametrize("plant", list(SCRIPT_PLANTS))
def test_script_checker_catches_a_planted_gap(plant):
    """A script with neither a counterpart nor an entry, or a counterpart
    whose main lacks a parameter, fails the check; an entry accounts for a
    script with no counterpart, and one that names nothing missing is
    stale."""
    scripts, want = SCRIPT_PLANTS[plant]
    assert script_gaps(scripts, {}) == [want]
    if plant == "option":
        key = "examples/planted.py --planted"
        assert script_gaps(scripts, {key: "planted in this test"}) == []
        assert script_gaps({p: SCRIPT for p in scripts}, {key: "planted in this test"}) == [f"stale entry {key}"]
    elif plant == "script":
        assert script_gaps(scripts, {"examples/planted.py": "planted in this test"}) == []
        assert script_gaps({}, {"examples/planted.py": "planted in this test"}) == ["stale entry examples/planted.py"]
    else:
        assert script_gaps(scripts, {"examples/planted.py": "planted in this test"}) == [
            "examples/planted.py is in SCRIPTS_NOT_PORTED but has examples/planted_torch.py", want]
