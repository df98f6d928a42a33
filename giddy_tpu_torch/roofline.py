"""Speed-of-light accounting of a decode on the card (counterpart of
giddy_tpu/roofline.py :1-130).

The least a decode can move is its compressed streams read once and its
decoded column written once, whatever implements it; the floor time is
those bytes over the card's memory rate (:func:`chip_bw`).
:func:`traffic_audit` is the single-pass evidence: the decoder that
``api.decode`` dispatches, run once more on streams already on the card,
must allocate nothing beside its output (``temp_bytes == 0``).

The compute side (counterpart of giddy_tpu/roofline.py :133-424):
:func:`chip_rates` gives the card's instruction rates a pipe,
:func:`ops_budget` the instructions a value each pipe can retire while
memory feeds the column, :func:`sass_census` counts a compiled kernel's
SASS instructions a value by pipe, and :func:`ops_audit` takes that census
of the kernel ``api.decode`` dispatches and holds it to the budget.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import pathlib
import re
import subprocess

import torch

from .format import EncodedColumn

# Device memory rates (bytes/s) from NVIDIA's H100 data sheet, keyed by
# torch.cuda.get_device_name(): the SXM part (80 GB HBM3), the PCIe part
# (80 GB HBM2e) and the NVL part (94 GB HBM3).
HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}


def chip_bw(device_name: str | None = None) -> float:
    """The memory rate of ``device_name`` (by default the current card's);
    a card not in :data:`HBM_BW` raises ``ValueError``."""
    if device_name is None:
        device_name = torch.cuda.get_device_name()
    try:
        return HBM_BW[device_name]
    except KeyError:
        raise ValueError(f"no memory rate known for {device_name!r} (known: {sorted(HBM_BW)})") from None


# SM count and maximum SM clock (Hz) of each part, from NVIDIA's H100 data
# sheet, keyed as HBM_BW; on the card, torch.cuda.get_device_properties()
# .multi_processor_count and nvidia-smi's clocks.max.sm give them.
SM_CLOCK = {
    "NVIDIA H100 80GB HBM3": (132, 1.98e9),
    "NVIDIA H100 PCIe": (114, 1.755e9),
    "NVIDIA H100 NVL": (132, 1.785e9),
}
# Thread instructions an SM retires a clock, by pipe, for compute
# capability 9.0: the CUDA C++ Programming Guide's table "Throughput of
# Native Arithmetic Instructions (Operations per Clock Cycle per
# Multiprocessor)", the rows the census uses. issue: four schedulers, one
# warp instruction a clock each. alu: 32-bit integer add, compare,
# min/max, shift and logic. imad: 32-bit integer multiply and
# multiply-add, which share the fma pipe's half-rate lanes. fma: 32-bit
# floating-point add, multiply and multiply-add. xu: population count,
# count of leading zeros, bit reverse and most conversions. lsu: the warp
# shuffle row, one warp instruction a clock an SM, which is also the rate
# at which the SM's load/store path takes a 32-bit access a lane. The
# uniform and control classes have no row: only the issue rate bounds them.
PER_SM_CLOCK = {"issue": 128, "alu": 64, "imad": 64, "fma": 128, "xu": 16, "lsu": 32}


def chip_rates(device_name: str | None = None) -> dict[str, float]:
    """Thread instructions a second of ``device_name`` (by default the
    current card's) for each pipe of :data:`PER_SM_CLOCK` and for issue, at
    the maximum SM clock; a card not in :data:`SM_CLOCK` raises
    ``ValueError``."""
    if device_name is None:
        device_name = torch.cuda.get_device_name()
    try:
        sms, clock = SM_CLOCK[device_name]
    except KeyError:
        raise ValueError(f"no SM count and clock known for {device_name!r} (known: {sorted(SM_CLOCK)})") from None
    return {pipe: sms * per * clock for pipe, per in PER_SM_CLOCK.items()}


@dataclasses.dataclass
class Roofline:
    decoded_bytes: int
    compressed_bytes: int
    hbm_bw: float

    @property
    def bytes_touched(self) -> int:
        return self.decoded_bytes + self.compressed_bytes

    @property
    def floor_time_s(self) -> float:
        return self.bytes_touched / self.hbm_bw

    @property
    def sol_decode_gbps(self) -> float:
        """Decoded GB/s at speed of light."""
        return self.decoded_bytes / 1e9 / self.floor_time_s

    def sol_fraction(self, measured_time_s: float) -> float:
        """The floor time over a measured one."""
        return self.floor_time_s / max(measured_time_s, 1e-12)


def column_roofline(col: EncodedColumn, device_name: str | None = None) -> Roofline:
    return Roofline(
        decoded_bytes=col.nbytes_decoded,
        compressed_bytes=col.nbytes_compressed,
        hbm_bw=chip_bw(device_name),
    )


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def traffic_audit(col: EncodedColumn, device: torch.device | str = "cuda") -> dict:
    """Bytes the decoder of ``col`` touches on ``device``, the reference's
    keys and definitions: ``args_bytes`` of its uploaded streams,
    ``out_bytes`` of its (padded, storage-width) output, ``temp_bytes``
    that it allocates beside them, ``traffic = args + out + 2*temp`` (a
    temporary is written once and read once), ``ratio = traffic / (args +
    out)`` and ``sol_ratio = traffic / (compressed + out)``, which also
    charges the host prep's inflation of the streams. A ratio r caps the
    decode at 1/r of speed of light.

    On the card the streams are uploaded and the decoder run once before
    the measured run (the first launch loads the kernel library), and
    ``temp_bytes`` is the allocator's peak during that run less what is
    still allocated after it: the allocation before the call and the
    output's block (which the caching allocator may hand out up to 1 MB
    larger than the output; a decoder that returns its input, raw, holds
    none). On the CPU (``interpreted``: the plain versions run) torch keeps
    no allocator statistics: ``temp_bytes`` and the ratios are None and the
    byte accounting alone is reported."""
    from . import api

    device = api._decode_device(device)
    fn = api.get_decoder(col, api.narrow_store_dtype(col))
    streams = api.device_streams(col, device)
    args = sum(_nbytes(t) for t in streams.values())
    temp = None
    if device.type == "cuda":
        fn(streams)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = fn(streams)
        torch.cuda.synchronize(device)
        temp = torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device)
    else:
        out = fn(streams)
    out_bytes = _nbytes(out)
    traffic = None if temp is None else args + out_bytes + 2 * temp
    return {
        "scheme": col.scheme,
        "n": col.n,
        "args_bytes": args,
        "out_bytes": out_bytes,
        "temp_bytes": temp,
        "traffic_bytes": traffic,
        "ideal_bytes": args + out_bytes,
        "ratio": None if traffic is None else traffic / max(args + out_bytes, 1),
        "sol_ratio": None if traffic is None else traffic / max(col.nbytes_compressed + out_bytes, 1),
        "compressed_bytes": col.nbytes_compressed,
        "decoded_bytes": col.nbytes_decoded,
        "interpreted": device.type != "cuda",
    }


def ops_budget(col: EncodedColumn, device_name: str | None = None) -> dict:
    """Instructions a value that each pipe of ``device_name`` (by default
    the current card's) can retire while memory feeds the column
    (giddy_tpu/roofline.py :176-201): a pipe is no bottleneck while the
    decode's instructions a value on it stay at or under ``rate *
    bytes_per_elem / chip_bw``. ``bytes_per_elem`` is the reference's: the
    compressed bytes plus the group-padded output the kernel writes, over
    the padded value count, the normalization :func:`ops_audit` uses for
    its counts. No port kernel uses a tensor core, so there is no MMA
    budget. Arithmetic only: it runs on the CPU given a ``device_name``."""
    from .util import GROUP, num_groups

    n_pad = max(num_groups(col.n) * GROUP, 1)
    itemsize = max(col.nbytes_decoded // max(col.n, 1), 1)
    bytes_per_elem = (col.nbytes_compressed + n_pad * itemsize) / n_pad
    bw = chip_bw(device_name)
    budget = {f"{pipe}_per_elem": rate * bytes_per_elem / bw for pipe, rate in chip_rates(device_name).items()}
    return {"device_name": device_name, "bytes_per_elem": bytes_per_elem, **budget}


# -- the SASS census -----------------------------------------------------------
# Opcodes of sm_90a SASS by the pipe that retires them (:data:`PER_SM_CLOCK`
# names the rates). An opcode in no class is charged to ``unknown`` and
# shows as ``?OPCODE``, so a new kind of instruction cannot pass uncounted
# (the reference's closed-census rule, giddy_tpu/roofline.py :363-366).
# VIADD, VIMNMX, VIMNMX3 and VIADDMNMX are Hopper's integer add and min/max
# forms, I2FP its integer-to-float convert on the integer path (not the XU
# conversions); REDUX, the warp reduction into a uniform register, takes
# the shuffle path as SHFL does; an HFMA2 (the compiler's way to set a
# register pair) the fma pipe.
OPCODE_PIPE = {
    **dict.fromkeys("""IADD3 IADD IADD32I LOP3 LOP LOP32I SHF SHL SHR ISETP ICMP SEL FSEL LEA PRMT MOV MOV32I
        IMNMX VIADD VIMNMX VIMNMX3 VIADDMNMX PLOP3 P2R R2P BMSK SGXT IABS ISCADD FMNMX FSETP FSET CSET CSETP I2FP
        FCHK""".split(), "alu"),
    **dict.fromkeys("IMAD IMADSP IMUL IMUL32I FFMA FFMA32I FADD FADD32I FMUL FMUL32I HFMA2 HADD2 HMUL2".split(),
                    "fma"),
    **dict.fromkeys("POPC FLO BREV MUFU I2F F2I F2F I2I F2FP FRND".split(), "xu"),
    **dict.fromkeys("""LDG STG LDS STS LD ST LDL STL LDC LDSM LDGSTS LDGDEPBAR SHFL ATOM ATOMS ATOMG RED REDUX
        SYNCS MATCH CCTL""".split(), "lsu"),
    **dict.fromkeys("S2UR R2UR".split(), "uniform"),
    **dict.fromkeys("""BRA BRX JMP JMX EXIT BAR BSSY BSYNC NOP WARPSYNC DEPBAR S2R CS2R VOTE VOTEU ELECT
        ENDCOLLECTIVE CALL RET YIELD FENCE MEMBAR ERRBAR BPT KILL NANOSLEEP ACQBULK WARPGROUP""".split(),
                    "control"),
}
# IMAD and IMUL forms retire at the fma pipe's half rate (``imad``, counted
# inside ``fma`` as well).
IMAD_OPCODES = frozenset("IMAD IMADSP IMUL IMUL32I".split())
_INSTRUCTION = re.compile(
    r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")


def opcode_pipe(opcode: str) -> str | None:
    """The class of ``opcode`` (without its modifiers), or None."""
    pipe = OPCODE_PIPE.get(opcode)
    if pipe is None and opcode.startswith("U"):  # the uniform datapath: ULDC, UIADD3, UBLKCP, ...
        return "uniform"
    return pipe


def kernel_key(name: str) -> str:
    """A SASS function's (demangled) name without its return type and its
    parameter list: ``void gt::f<int, (gt::M)0>(int *)`` -> ``gt::f<int,
    (gt::M)0>``, the name the wrappers' census functions give."""
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[5:] if name.startswith("void ") else name


def sass_functions(sass: str) -> dict[str, str]:
    """``cuobjdump -sass`` text -> {kernel_key(function name): its text}."""
    out = {}
    parts = re.split(r"^\s*Function : (.*)$", sass, flags=re.M)
    for name, body in zip(parts[1::2], parts[2::2]):
        out[kernel_key(name.strip())] = body
    return out


def _instructions(body: str) -> list[tuple[int, bool, str, int | None]]:
    """(address, predicated, opcode with its modifiers, branch target) of
    each instruction of one function's SASS."""
    out = []
    for line in body.splitlines():
        m = _INSTRUCTION.match(line)
        if m:
            opcode = m.group(3) + m.group(4)
            target = _TARGET.search(m.group(5)) if m.group(3) in ("BRA", "CALL", "JMP") else None
            out.append((int(m.group(1), 16), m.group(2) is not None, opcode, target and int(target.group(1), 16)))
    return out


def _regions(ins: list) -> list[tuple[int, int]]:
    """The executed regions of a function, as (first, last) indexes into
    ``ins``: the main body up to its last unpredicated EXIT, then each
    subroutine a CALL reaches (up to its RET), callers before callees. Code
    after the main body that no CALL reaches is cold: the fallback of a
    divergent warp (BRA.DIV's target), the retry loop of an mbarrier wait
    that failed, and the alignment padding."""
    at = {a: i for i, (a, *_rest) in enumerate(ins)}
    exits = [i for i, (_, pred, op, _t) in enumerate(ins) if op == "EXIT" and not pred]
    regions = [(0, exits[-1] if exits else len(ins) - 1)]
    k = 0
    while k < len(regions):
        first, last = regions[k]
        for _, _pred, op, target in ins[first:last + 1]:
            if op.startswith("CALL") and target in at:
                start = at[target]
                end = next((j for j in range(start, len(ins)) if ins[j][2].startswith("RET")), len(ins) - 1)
                if (start, end) not in regions:
                    regions.append((start, end))
        k += 1
    return regions


def _is_trap(instruction) -> bool:
    """The branch to itself that ends a function's code (padding follows)."""
    address, pred, op, target = instruction
    return op == "BRA" and not pred and target == address


COUNTS = ("issue", "alu", "imad", "fma", "xu", "lsu", "uniform", "control", "unknown")


def _weights(op: str) -> dict[str, float]:
    """What one instruction adds to each count of :data:`COUNTS`."""
    base = op.split(".")[0]
    pipe = opcode_pipe(base) or "unknown"
    w = {"issue": 1.0, pipe: 1.0}
    if base in IMAD_OPCODES:
        w["imad"] = 1.0
    return w


class _Function:
    """One function's instructions, executed regions and loops."""

    def __init__(self, body: str, name: str):
        self.ins = _instructions(body)
        if not self.ins:
            raise ValueError(f"SASS function {name!r} has no instructions")
        self.at = {a: i for i, (a, *_rest) in enumerate(self.ins)}
        self.regions = _regions(self.ins)
        self.region_of: dict[int, int] = {}
        for r, (first, last) in enumerate(self.regions):
            for i in range(first, last + 1):
                self.region_of.setdefault(i, r)
        heads: dict[int, int] = {}  # a loop's first index -> its last back edge's index
        for i, (_, _pred, op, target) in enumerate(self.ins):
            j = self.at.get(target) if op.startswith("BRA") else None
            if j is not None and j <= i and i in self.region_of and self.region_of.get(j) == self.region_of[i]:
                heads[j] = max(heads.get(j, i), i)
        self.loops = sorted(heads.items())
        for (s1, e1), (s2, e2) in zip(self.loops, self.loops[1:]):
            if s2 <= e1 < e2:  # the next loop starts inside this one and ends past it
                raise ValueError(f"SASS function {name!r}: loops at {self.ins[s1][0]:#x} and {self.ins[s2][0]:#x} overlap")

    def target(self, i: int) -> int | None:
        return self.at.get(self.ins[i][3]) if self.ins[i][2].startswith(("BRA", "CALL")) else None

    def shortest(self, lo: int, hi: int, trips: list, key: str) -> float:
        """The least ``key`` count of a path through instructions lo..hi
        that starts at lo and leaves the range (falls off hi, branches out of
        it, or exits), forward edges only, plus each loop inside the range
        (the outermost ones; a path passes over them) ``trips`` times its own
        least body; a CALL adds its subroutine's least path. A path may skip
        what a branch skips: a block that a guard keeps to some warps, the
        shorter arm of an if/else, an early exit."""
        inner = [(n, s, e) for n, (s, e) in enumerate(self.loops) if lo < s and e <= hi]
        jump = {s: (e, n) for n, s, e in inner if not any(s2 < s and e <= e2 for _, s2, e2 in inner)}
        # an instruction inside one of those loops is reached through the loop
        enter = {i: s for s, (e, _n) in jump.items() for i in range(s, e + 1)}
        inf = float("inf")
        out = hi - lo + 1
        best = [inf] * (out + 1)  # least count from lo to instruction lo + k; best[out]: left the range
        best[0] = 0.0

        def reach(j: int, cost: float) -> None:
            k = enter.get(j, j) - lo if lo <= j <= hi else out
            best[k] = min(best[k], cost)

        for i in range(lo, hi + 1):
            c = best[i - lo]
            if c == inf or (i in enter and i not in jump):
                continue
            if i in jump:  # the loop's runs are charged below, whichever way a path passes it
                reach(jump[i][0] + 1, c)
                continue
            _, pred, op, target = self.ins[i]
            cost = c + _weights(op).get(key, 0.0)
            j = self.target(i)
            if op.startswith("CALL") and j is not None and self.region_of.get(j, 0) != 0:
                first, last = self.regions[self.region_of[j]]
                cost += self.shortest(first, last, trips, key)
            if op.startswith("BRA") and target is not None:
                if j is not None and j in self.region_of:
                    reach(j if i < j else hi + 1, cost)  # a back edge ends this run of the range
                if not pred and ".DIV" not in op:
                    continue  # unconditional: no fallthrough (a jump into cold code ends the path)
            elif op.startswith(("EXIT", "RET")):
                reach(hi + 1, cost)
                if not pred:
                    continue
            reach(i + 1, cost)
        loops = sum(0.0 if trips[n] == 0 else (1.0 if trips[n] is None else trips[n]) * self.shortest(s, e, trips, key)
                    for s, (e, n) in jump.items())
        return best[out] + loops


@functools.lru_cache(maxsize=64)
def _parsed(sass: str) -> dict[str, str]:
    return sass_functions(sass)


def sass_census(sass: str, function: str, trips=(), threads: int = 1, n_pad: int = 1) -> dict:
    """SASS instructions of ``function`` (a kernel_key, or the name its
    header gives) in ``sass``, by pipe, a value: each instruction's count
    times its multiplicity times ``threads`` (the threads launched) over
    ``n_pad`` (the padded values), in ``<pipe>_per_elem``.

    Every instruction takes an issue slot, a predicated one too.
    Straight-line code counts once a thread; the body of a loop (from a
    backward branch's target to the branch; back edges to one target are
    one loop) counts ``trips`` times, and nested loops multiply. ``trips``
    gives each loop's trip count in SASS order (by the address of its first
    instruction; a subroutine's loops after the main body's), as the times
    a warp runs the body, averaged over the warps launched (a loop that one
    warp of eight runs 4 times: 0.5), per run of the enclosing loop's body:
    None for a loop whose trips are data, which is charged once and sets
    ``has_unbounded_loop`` (as the reference charges a ``while`` once). When
    the loops found are not as many as ``trips`` holds, every loop is
    charged once and ``loops_mismatch`` is set: the census does not guess.
    A subroutine a CALL reaches counts once a call. Cold code (see
    :func:`_regions`) is not counted; ``cold_instructions`` says how much
    of it there is.

    That counts every path, both arms of an if/else and the blocks a guard
    keeps to one warp alike. ``floor_<pipe>_per_elem`` counts the least a
    warp must issue instead (:meth:`_Function.shortest`), with the same
    trips: a lower bound on what runs, which the floors divide by the rates."""
    funcs = _parsed(sass)
    body = funcs.get(kernel_key(function), funcs.get(function))
    if body is None:
        raise KeyError(f"no SASS function {function!r}")
    f = _Function(body, function)
    ins, loops = f.ins, f.loops
    trips = list(trips)
    mismatch = len(trips) != len(loops)
    declared = [None] * len(loops) if mismatch else trips
    in_loops = [1.0] * len(ins)
    for (start, end), n in zip(loops, declared):
        for i in range(start, end + 1):
            in_loops[i] *= 1.0 if n is None else float(n)
    mult = [0.0] * len(ins)
    for r, (first, last) in enumerate(f.regions):  # callers come before their callees
        base = 1.0 if r == 0 else sum(
            mult[i] for i in range(len(ins)) if ins[i][2].startswith("CALL") and f.target(i) == first)
        for i in range(first, last + 1):
            if f.region_of[i] == r:
                mult[i] = base * in_loops[i]
    scale = threads / max(n_pad, 1)
    counts = dict.fromkeys(COUNTS, 0.0)
    ops: collections.Counter = collections.Counter()
    for (_, _pred, op, _t), m in zip(ins, mult):
        if m:
            for key, w in _weights(op).items():
                counts[key] += w * m * scale
            base = op.split(".")[0]
            ops[base if opcode_pipe(base) else f"?{base}"] += m * scale
    first, last = f.regions[0]
    trap = next((i for i, x in enumerate(ins) if _is_trap(x)), len(ins))
    return {
        "function": function,
        **{f"{key}_per_elem": v for key, v in counts.items()},
        **{f"floor_{key}_per_elem": f.shortest(first, last, declared, key) * scale for key in COUNTS[:6]},
        "loops": [(ins[s][0], ins[e][0], n) for (s, e), n in zip(loops, declared)],
        "loops_mismatch": mismatch,
        "has_unbounded_loop": any(n is None for n in declared),
        "cold_instructions": sum(1 for i in range(trap) if not mult[i]),
        "ops_per_elem": dict(ops),
    }


# -- the census of the card's kernels -------------------------------------------


def _tool(name: str) -> str:
    """A CUDA toolkit program that sits beside nvcc (cuobjdump, cu++filt)."""
    from .kernels import _build

    path = pathlib.Path(_build._nvcc()).parent / name
    if not path.exists():
        raise RuntimeError(f"{name} not found beside nvcc ({path})")
    return str(path)


def library_sass() -> str:
    """The SASS of the built kernel library (``cuobjdump -sass``), its
    function names demangled (``cu++filt``). Cached beside the library,
    under its own hash, so a build disassembles once."""
    from .kernels import _build

    _build.lib()
    return _library_sass(_build.library_path())


@functools.lru_cache(maxsize=1)
def _library_sass(lib: pathlib.Path) -> str:
    cache = lib.with_suffix(".sass")
    if not cache.exists():
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True, check=True,
                              timeout=600).stdout
        names = sorted(set(re.findall(r"Function : (\S+)", text)))
        plain = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True, text=True,
                               check=True, timeout=60).stdout.splitlines()
        table = dict(zip(names, plain))
        text = re.sub(r"(Function : )(\S+)", lambda m: m.group(1) + table.get(m.group(2), m.group(2)), text)
        tmp = cache.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, cache)  # atomic, as the library's own build
    return cache.read_text()


def census_of(launches: list, values: int, sass: str | None = None) -> dict:
    """The SASS census (:func:`sass_census`) of a call's launches (each a
    kernels._wrap.Launch: kernel instance, threads, loop trips, as the
    wrapper module's ``census`` gives them), summed, a value of ``values``
    (the padded values the call reads or writes). No launch, no count.
    Reads the built library's SASS (:func:`library_sass`) unless ``sass``
    is given; nothing is launched."""
    if launches and sass is None:
        sass = library_sass()
    parts = [sass_census(sass, l.kernel, l.trips, l.threads, values) for l in launches]
    keys = [f"{key}_per_elem" for key in COUNTS] + [f"floor_{key}_per_elem" for key in COUNTS[:6]]
    ops: collections.Counter = collections.Counter()
    for p in parts:
        ops.update(p["ops_per_elem"])
    return {
        **{key: sum(p[key] for p in parts) for key in keys},
        "kernels": [p["function"] for p in parts],
        "loops": [p["loops"] for p in parts],
        "loops_mismatch": any(p["loops_mismatch"] for p in parts),
        "has_unbounded_loop": any(p["has_unbounded_loop"] for p in parts),
        "ops_per_elem": dict(ops),
    }


def kernel_census(name: str, args: tuple, values: int, sass: str | None = None) -> dict:
    """:func:`census_of` a call of the port's kernel ``name`` (a
    kernels.WRAPPERS key) on the wrapper arguments ``args``; a call of
    several launches (K15: its count kernel and its decode) sums theirs."""
    from . import kernels

    return census_of(kernels.WRAPPERS[name].census(name, args), values, sass)


def floors_ms(census: dict, values: int, device_name: str | None = None) -> dict[str, float]:
    """Each pipe's floor and the issue floor of a census, in ms: the least
    instructions a value that must run (``floor_<pipe>_per_elem``) times
    ``values`` over the pipe's rate, at the maximum clock."""
    rates = chip_rates(device_name)
    return {pipe: census[f"floor_{pipe}_per_elem"] * values / rate * 1e3 for pipe, rate in rates.items()}


def ops_audit(col: EncodedColumn, device: torch.device | str = "cuda", device_name: str | None = None) -> dict:
    """Compute-side roofline of the decoder ``api.decode`` dispatches for
    ``col`` (giddy_tpu/roofline.py :369-424, for Hopper): the SASS census of
    the kernel kernels.kernel_call picks on the column's device streams, a
    value (padded), by pipe, against :func:`ops_budget`. ``memory_bound``:
    every pipe and issue at or under its budget; ``issue_headroom``: the
    issue budget over the census; ``top_ops_per_elem``: the 12 opcodes that
    issue most. Counts are every path's (sass_census), a cautious verdict;
    ``floor_*`` the least that runs.

    On the CPU (``interpreted``: the plain versions run, there is no SASS)
    the counts are None, and the budget is ``device_name``'s (a card's
    torch.cuda.get_device_name) when it is given, else None. On the card a
    missing cuobjdump or a kernel name with no SASS function raises."""
    from . import api, kernels
    from .util import GROUP, num_groups

    n_pad = num_groups(col.n) * GROUP
    device = api._decode_device(device)
    result = {"scheme": col.scheme, "n": col.n, "n_pad": n_pad}
    if device.type != "cuda":
        budget = ops_budget(col, device_name) if device_name else None
        counts = [f"{key}_per_elem" for key in COUNTS] + [f"floor_{key}_per_elem" for key in COUNTS[:6]]
        return {**result, **dict.fromkeys(counts), "has_unbounded_loop": None, "loops_mismatch": None,
                "kernels": None, "budget": budget, "issue_headroom": None, "memory_bound": None,
                "top_ops_per_elem": None, "interpreted": True}
    with torch.cuda.device(device):
        budget = ops_budget(col, device_name or torch.cuda.get_device_name(device))
        # raw decodes to its own stream and an empty column to zeros: no kernel runs
        name, launches = None, []
        if col.scheme != "raw" and n_pad and not (col.scheme == "cascade" and col.params["dict_size"] == 0):
            name, args = kernels.kernel_call(col, api.device_streams(col, device), api.narrow_store_dtype(col))
            launches = kernels.WRAPPERS[name].census(name, args)
        c = census_of(launches, n_pad)
    top = sorted(c["ops_per_elem"].items(), key=lambda kv: -kv[1])[:12]
    return {
        **result,
        "kernel": name,
        **{k: c[k] for k in c if k.endswith("_per_elem") and k != "ops_per_elem"},
        "has_unbounded_loop": c["has_unbounded_loop"],
        "loops_mismatch": c["loops_mismatch"],
        "kernels": c["kernels"],
        "budget": budget,
        "issue_headroom": budget["issue_per_elem"] / max(c["issue_per_elem"], 1e-9),
        "memory_bound": all(c[f"{p}_per_elem"] <= budget[f"{p}_per_elem"] for p in PER_SM_CLOCK),
        "top_ops_per_elem": {k: round(v, 3) for k, v in top},
        "interpreted": False,
    }
