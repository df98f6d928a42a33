"""giddy_tpu_torch.roofline on the CPU against giddy_tpu.roofline: the
roofline's byte counts, the traffic audit's byte accounting (its streams
against the reference's ``api.device_streams``, computed in a fresh
process, and its storage-width outputs) and the table of memory rates.
The audit's temporary bytes need the card's allocator: on the CPU they are
None, and tests/test_torch_cuda.py holds them on the card. The compute
side: ops_budget's bytes a value against giddy_tpu.roofline.ops_budget,
the table of rates, the SASS census on SASS texts written here and on one
kernel's SASS as the card's toolkit printed it, and the wrappers' loop
trips; tests/test_torch_cuda.py takes the census of every kernel."""

import numpy as np
import pytest
import torch

import giddy_tpu as gt
from giddy_tpu import roofline as gt_roofline
import giddy_tpu_torch as gtt
from giddy_tpu_torch import roofline
from giddy_tpu_torch.datagen import CORE_SCHEMES, gen_column
from giddy_tpu_torch.kernels import _wrap
from giddy_tpu_torch.util import GROUP, LANES

from test_torch_inputs import FreshProcess, rng_of

N = 8 * GROUP  # the reference's audit size (tests/test_roofline.py)
H100_SXM = "NVIDIA H100 80GB HBM3"


def _column(scheme: str):
    v = gen_column(scheme, N, rng_of(f"roofline/{scheme}"))
    return v, gtt.encode(v, scheme, name=f"audit_{scheme}")


def reference_args_bytes(values: np.ndarray, scheme: str) -> int:
    """The byte total of giddy_tpu.api.device_streams of the reference's
    column (run in a fresh process: it places arrays with JAX)."""
    from giddy_tpu import api

    streams = api.device_streams(gt.encode(values, scheme, name=f"audit_{scheme}"))
    return sum(int(np.asarray(s).nbytes) for s in streams.values())


@pytest.fixture(scope="module")
def reference():
    process = FreshProcess()
    yield process
    process.close()


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_column_roofline_matches_reference(scheme):
    v, col = _column(scheme)
    want = gt_roofline.column_roofline(gt.encode(v, scheme, name=f"audit_{scheme}"), "v5e")
    got = roofline.column_roofline(col, H100_SXM)
    assert (got.decoded_bytes, got.compressed_bytes, got.bytes_touched) == (
        want.decoded_bytes, want.compressed_bytes, want.bytes_touched)
    assert got.hbm_bw == 3.35e12 and got.floor_time_s == got.bytes_touched / 3.35e12
    assert got.sol_decode_gbps == pytest.approx(got.decoded_bytes / 1e9 / got.floor_time_s)
    assert got.sol_fraction(2 * got.floor_time_s) == pytest.approx(0.5)


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_audit_streams_match_reference(reference, scheme):
    v, col = _column(scheme)
    a = roofline.traffic_audit(col, "cpu")
    assert a["args_bytes"] == reference(reference_args_bytes, v, scheme)
    assert a["out_bytes"] == N * 4 and a["ideal_bytes"] == a["args_bytes"] + a["out_bytes"]
    assert a["interpreted"] is True and a["temp_bytes"] is None
    assert a["traffic_bytes"] is a["ratio"] is a["sol_ratio"] is None
    assert (a["scheme"], a["n"], a["compressed_bytes"], a["decoded_bytes"]) == (
        scheme, N, col.nbytes_compressed, col.nbytes_decoded)


NARROW = [
    ("nbit", "uint8"), ("for", "uint16"), ("delta", "int16"), ("dict", "int8"), ("rle", "int16"),
    ("dzbv", "uint16"), ("bitmap", "uint8"), ("patched", "int16"), ("cascade", "int16"), ("raw", "int8"),
]


@pytest.mark.parametrize("n", [GROUP + 5, 40 * GROUP + 13])
@pytest.mark.parametrize("scheme,dtype", NARROW)
def test_audit_out_bytes_at_storage_width(scheme, dtype, n):
    """The decoder's output is the column's storage width a value (raw
    keeps its int32 payload, as the reference's raw does), over whole
    groups, at one group and at many."""
    rng = rng_of(f"roofline/narrow/{scheme}/{dtype}/{n}")
    v = (np.repeat(rng.integers(0, 4, n // 8 + 1), 8)[:n] * 7).astype(dtype)  # bitmap: d = 4
    col = gtt.encode(v, scheme)
    a = roofline.traffic_audit(col, "cpu")
    width = 4 if scheme == "raw" else np.dtype(dtype).itemsize
    assert a["out_bytes"] == -(-n // GROUP) * GROUP * width


def test_chip_bw_table():
    assert roofline.chip_bw(H100_SXM) == 3.35e12
    assert roofline.chip_bw("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.chip_bw("NVIDIA H100 NVL") == 3.9e12
    for name in ("TPU v5 lite", "v5e", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no memory rate known"):
            roofline.chip_bw(name)
    _, col = _column("nbit")
    with pytest.raises(ValueError, match="TPU v5p"):
        roofline.column_roofline(col, "TPU v5p")


def test_audit_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py audits there")
    _, col = _column("nbit")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roofline.traffic_audit(col)


# -- the compute side: rates, budget, SASS census ------------------------------


@pytest.mark.parametrize("n", [N, GROUP + 1])
@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_ops_budget_bytes_match_reference(scheme, n):
    """bytes_per_elem is the reference's: compressed bytes plus the
    group-padded output over the padded count (GROUP + 1 pads a second
    group, the normalization tests/test_review_regressions.py pins)."""
    v = gen_column(scheme, n, rng_of(f"roofline/budget/{scheme}/{n}"))
    want = gt_roofline.ops_budget(gt.encode(v, scheme, name=f"budget_{scheme}"))["bytes_per_elem"]
    got = roofline.ops_budget(gtt.encode(v, scheme, name=f"budget_{scheme}"), H100_SXM)
    assert got["bytes_per_elem"] == want
    rates = roofline.chip_rates(H100_SXM)
    for pipe, rate in rates.items():
        assert got[f"{pipe}_per_elem"] == rate * want / 3.35e12
    assert "mxu_macs_per_elem" not in got and got["device_name"] == H100_SXM


@pytest.mark.parametrize("name", sorted(roofline.SM_CLOCK))
def test_chip_rates_table(name):
    sms, clock = roofline.SM_CLOCK[name]
    rates = roofline.chip_rates(name)
    assert rates["issue"] == 128 * sms * clock and rates["alu"] == rates["issue"] / 2
    assert rates["imad"] == rates["alu"] and rates["fma"] == rates["issue"]
    assert rates["xu"] == rates["issue"] / 8 and rates["lsu"] == rates["issue"] / 4
    assert set(roofline.chip_rates(name)) == set(roofline.PER_SM_CLOCK) and name in roofline.HBM_BW


def test_chip_rates_of_the_sxm_part_and_an_unknown_card():
    assert roofline.SM_CLOCK[H100_SXM] == (132, 1.98e9)
    assert roofline.chip_rates(H100_SXM)["issue"] == pytest.approx(3.345e13, rel=1e-3)
    for name in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", ""):
        with pytest.raises(ValueError, match="no SM count and clock known"):
            roofline.chip_rates(name)


def _sass(*functions) -> str:
    """cuobjdump -sass text of functions given as (name, [instruction, ...]),
    an instruction a line from address 0 in steps of 16."""
    out = []
    for name, body in functions:
        out.append(f"\t\tFunction : {name}")
        out.append('\t.headerflags\t@"EF_CUDA_SM90"')
        out += [f"        /*{16 * i:04x}*/                   {x} ;" for i, x in enumerate(body)]
    return "\n".join(out)


def test_sass_census_classes_and_predicates():
    body = ["S2R R0, SR_TID.X", "IADD3 R1, R0, 0x1, RZ", "@P0 LOP3.LUT R2, R1, 0x3, RZ, 0xc0, !PT",
            "IMAD.WIDE R4, R0, 0x4, R4", "FFMA R6, R6, R7, R8", "@!P1 POPC R9, R2", "LDG.E R3, desc[UR4][R4.64]",
            "SHFL.UP PT, R10, R3, 0x1, RZ", "ULDC.64 UR4, c[0x0][0x208]", "R2UR UR6, R3", "STG.E desc[UR4][R4.64], R3",
            "EXIT", "BRA 0xc0", "NOP"]
    c = roofline.sass_census(_sass(("gt::k", body)), "gt::k", threads=64, n_pad=32)
    assert c["issue_per_elem"] == 12 * 2  # the predicated ones count; the trap and padding do not
    assert (c["alu_per_elem"], c["fma_per_elem"], c["imad_per_elem"], c["xu_per_elem"]) == (4, 4, 2, 2)
    assert (c["lsu_per_elem"], c["uniform_per_elem"], c["control_per_elem"]) == (6, 4, 4)
    assert c["unknown_per_elem"] == 0 and c["cold_instructions"] == 0 and c["loops"] == []
    assert c["ops_per_elem"]["LOP3"] == 2 and not c["has_unbounded_loop"] and not c["loops_mismatch"]


def test_sass_census_surfaces_an_unknown_opcode():
    c = roofline.sass_census(_sass(("gt::k", ["IADD3 R1, R0, 0x1, RZ", "FROB.X R2, R1", "EXIT"])), "gt::k")
    assert c["unknown_per_elem"] == 1 and c["ops_per_elem"]["?FROB"] == 1 and c["issue_per_elem"] == 3


def test_sass_census_loops_and_nesting():
    body = ["MOV R0, RZ",                   # 0x00
            "IADD3 R1, R1, 0x1, RZ",        # 0x10  outer loop
            "LOP3.LUT R2, R1, 0x1, RZ, 0xc0, !PT",  # 0x20  inner loop
            "ISETP.NE.AND P0, PT, R2, RZ, PT",      # 0x30
            "@P0 BRA 0x20",                 # 0x40  inner back edge
            "ISETP.NE.AND P1, PT, R1, 0x8, PT",     # 0x50
            "@P1 BRA 0x10",                 # 0x60  outer back edge
            "EXIT"]
    sass = _sass(("gt::k", body))
    c = roofline.sass_census(sass, "gt::k", trips=(8, 4))
    assert c["loops"] == [(0x10, 0x60, 8), (0x20, 0x40, 4)]
    assert c["issue_per_elem"] == 1 + 8 * (3 + 4 * 3) + 1
    assert c["ops_per_elem"]["LOP3"] == 32 and c["ops_per_elem"]["ISETP"] == 8 * 4 + 8
    assert not c["has_unbounded_loop"] and not c["loops_mismatch"]
    once = roofline.sass_census(sass, "gt::k", trips=(None, 4))  # trips that are data: charged once
    assert once["has_unbounded_loop"] and once["issue_per_elem"] == 1 + (3 + 4 * 3) + 1
    wrong = roofline.sass_census(sass, "gt::k", trips=(8,))  # a loop not declared: every loop charged once
    assert wrong["loops_mismatch"] and wrong["issue_per_elem"] == 1 + 3 + 3 + 1


def test_sass_census_one_loop_of_two_back_edges():
    body = ["MOV R0, RZ", "IADD3 R0, R0, 0x1, RZ", "@P0 BRA 0x10", "IADD3 R1, R1, 0x1, RZ", "@P1 BRA 0x10", "EXIT"]
    c = roofline.sass_census(_sass(("gt::k", body)), "gt::k", trips=(5,))
    assert c["loops"] == [(0x10, 0x40, 5)] and c["issue_per_elem"] == 1 + 5 * 4 + 1


def test_sass_census_floor_takes_the_shorter_path():
    """Every path counts in the census; the floor counts the least a warp
    must issue: the shorter arm of an if/else, no guarded block."""
    body = ["ISETP.NE.AND P0, PT, R0, RZ, PT",   # 0x00
            "@P0 BRA 0x50",                      # 0x10  if
            "IADD3 R1, R1, 0x1, RZ",             # 0x20  then: 3 instructions
            "IADD3 R1, R1, 0x1, RZ",             # 0x30
            "BRA 0x60",                          # 0x40
            "IMAD R1, R1, R2, RZ",               # 0x50  else: 1
            "@P1 BRA 0x80",                      # 0x60  guard
            "LDG.E R3, desc[UR4][R4.64]",        # 0x70  guarded
            "EXIT"]                              # 0x80
    c = roofline.sass_census(_sass(("gt::k", body)), "gt::k")
    assert c["issue_per_elem"] == 9
    assert c["floor_issue_per_elem"] == 2 + 1 + 1 + 1 and c["floor_lsu_per_elem"] == 0
    assert c["floor_alu_per_elem"] == 1 and c["floor_fma_per_elem"] == 0  # each pipe its own least path


def test_sass_census_counts_a_subroutine_at_its_calls_and_no_cold_code():
    body = ["CALL.REL.NOINC 0x60",     # 0x00
            "IADD3 R1, R1, 0x1, RZ",   # 0x10
            "BRA.DIV UR4, 0x50",       # 0x20  a divergent warp's fallback is cold
            "CALL.REL.NOINC 0x60",     # 0x30
            "EXIT",                    # 0x40
            "WARPSYNC.ALL",            # 0x50  cold
            "MUFU.RCP R2, R3",         # 0x60  subroutine
            "RET.REL.NODEC R4 0x0",    # 0x70
            "BRA 0x80"]                # 0x80  trap
    c = roofline.sass_census(_sass(("gt::k", body)), "gt::k")
    assert c["issue_per_elem"] == 5 + 2 * 2 and c["xu_per_elem"] == 2 and c["cold_instructions"] == 1
    assert c["floor_xu_per_elem"] == 2


def test_sass_census_finds_a_function_by_its_demangled_name():
    sass = _sass(("void gt::k<unsigned int, (gt::LutMode)1>(const unsigned int *, int)", ["EXIT"]),
                 ("void gt::k<unsigned int, (gt::LutMode)0>(const unsigned int *, int)", ["IADD3 R1, R1, 0x1, RZ", "EXIT"]))
    assert roofline.kernel_key("void gt::k<unsigned int, (gt::LutMode)0>(const unsigned int *, int)") == (
        "gt::k<unsigned int, (gt::LutMode)0>")
    assert roofline.sass_census(sass, "gt::k<unsigned int, (gt::LutMode)0>")["issue_per_elem"] == 2
    with pytest.raises(KeyError, match="no SASS function"):
        roofline.sass_census(sass, "gt::k<unsigned int, (gt::LutMode)2>")


# K8's kernel (csrc/run_decode.cu xordelta_decode_kernel) as cuobjdump -sass
# printed it from the port's library built on an NVIDIA H100 80GB HBM3 (nvcc
# for sm_90a, the flags of kernels/_build.py), its encoding words cut and its
# spaces narrowed. The 32 slots' loop runs two slots a turn, 16 turns.
XORDELTA_SASS = """
Function : _ZN2gt22xordelta_decode_kernelEPKjPKiPji
/*0000*/ LDC R1, c[0x0][0x28] ;
/*0010*/ S2R R13, SR_CTAID.X ;
/*0020*/ LDC.64 R8, c[0x0][0x218] ;
/*0030*/ ULDC UR5, c[0x0][0x228] ;
/*0040*/ ULDC.64 UR6, c[0x0][0x208] ;
/*0050*/ S2R R6, SR_TID.X ;
/*0060*/ USHF.R.S32.HI UR4, URZ, 0x1f, UR5 ;
/*0070*/ IMAD.WIDE.U32 R2, R13, UR5, RZ ;
/*0080*/ IMAD R5, R13, UR4, R3 ;
/*0090*/ SHF.R.S32.HI R7, RZ, 0x1f, R6 ;
/*00a0*/ ULDC.64 UR4, c[0x0][0x210] ;
/*00b0*/ LEA R0, P0, R2, R6, 0xa ;
/*00c0*/ LEA.HI.X R5, R2, R7, R5, 0xa, P0 ;
/*00d0*/ IMAD.WIDE.U32 R2, R13, 0x4, R8 ;
/*00e0*/ LEA R4, P0, R0, UR4, 0x2 ;
/*00f0*/ LEA.HI.X R5, R0, UR5, R5, 0x2, P0 ;
/*0100*/ LDG.E.CONSTANT R10, desc[UR6][R2.64] ;
/*0110*/ LDC R0, c[0x0][0x228] ;
/*0120*/ IMAD.WIDE.U32 R8, R13, 0x8000, R6 ;
/*0130*/ ULDC.64 UR4, c[0x0][0x220] ;
/*0140*/ LDG.E.CONSTANT R11, desc[UR6][R4.64] ;
/*0150*/ IMAD.MOV.U32 R14, RZ, RZ, RZ ;
/*0160*/ LEA R18, P0, R8, UR4, 0x2 ;
/*0170*/ IADD3 R18, P1, R18, 0x1000, RZ ;
/*0180*/ LEA.HI.X R19, R8, UR5, R9, 0x2, P0 ;
/*0190*/ CS2R R8, SRZ ;
/*01a0*/ IMAD.X R19, RZ, RZ, R19, P1 ;
/*01b0*/ IMAD.IADD R12, R14, 0x1, R0 ;
/*01c0*/ SHF.R.U32.HI R16, RZ, R14, R11 ;
/*01d0*/ IMAD.MOV.U32 R2, RZ, RZ, R18 ;
/*01e0*/ IMAD.MOV.U32 R3, RZ, RZ, R19 ;
/*01f0*/ ISETP.GE.AND P0, PT, R12, 0x20, PT ;
/*0200*/ @!P0 BRA 0x2d0 ;
/*0210*/ VIADD R9, R9, 0x1 ;
/*0220*/ ISETP.GT.AND P0, PT, R12, 0x20, PT ;
/*0230*/ IMAD.MOV.U32 R11, RZ, RZ, RZ ;
/*0240*/ IADD3 R18, -R14, 0x20, RZ ;
/*0250*/ ISETP.GE.AND P1, PT, R9, R0, PT ;
/*0260*/ @P1 BRA 0x290 ;
/*0270*/ IMAD.WIDE R14, R9, 0x1000, R4 ;
/*0280*/ LDG.E.CONSTANT R11, desc[UR6][R14.64] ;
/*0290*/ SHF.L.U32 R18, R11, R18, RZ ;
/*02a0*/ VIADD R12, R12, 0xffffffe0 ;
/*02b0*/ SEL R13, R18, RZ, P0 ;
/*02c0*/ LOP3.LUT R16, R13, R16, RZ, 0xfc, !PT ;
/*02d0*/ IMAD.MOV.U32 R13, RZ, RZ, -0x1 ;
/*02e0*/ ISETP.NE.AND P0, PT, R0, 0x20, PT ;
/*02f0*/ S2UR UR5, SR_CgaCtaId ;
/*0300*/ UMOV UR4, 0x400 ;
/*0310*/ IMAD.SHL.U32 R19, R6, 0x4, RZ ;
/*0320*/ SHF.L.U32 R13, R13, R0, RZ ;
/*0330*/ LOP3.LUT R13, RZ, R13, RZ, 0x33, !PT ;
/*0340*/ SEL R13, R13, 0xffffffff, P0 ;
/*0350*/ LOP3.LUT P0, R14, R6, 0x1f, RZ, 0xc0, !PT ;
/*0360*/ LOP3.LUT R16, R16, R13, RZ, 0xc0, !PT ;
/*0370*/ ISETP.GE.U32.AND P1, PT, R14.reuse, 0x2, PT ;
/*0380*/ ISETP.GE.U32.AND P2, PT, R14.reuse, 0x4, PT ;
/*0390*/ SHFL.UP PT, R15, R16, 0x1, RZ ;
/*03a0*/ ISETP.GE.U32.AND P3, PT, R14, 0x8, PT ;
/*03b0*/ ISETP.GE.U32.AND P4, PT, R14, 0x10, PT ;
/*03c0*/ ULEA UR4, UR5, UR4, 0x18 ;
/*03d0*/ P2R R21, PR, RZ, 0x10 ;
/*03e0*/ SEL R15, R15, RZ, P0 ;
/*03f0*/ LOP3.LUT R15, R16, R15, RZ, 0x3c, !PT ;
/*0400*/ SHFL.UP PT, R17, R15, 0x2, RZ ;
/*0410*/ SEL R18, R17, RZ, P1 ;
/*0420*/ LOP3.LUT R18, R15, R18, RZ, 0x3c, !PT ;
/*0430*/ SHFL.UP PT, R17, R18, 0x4, RZ ;
/*0440*/ SEL R17, R17, RZ, P2 ;
/*0450*/ LOP3.LUT R17, R18, R17, RZ, 0x3c, !PT ;
/*0460*/ P2R R18, PR, RZ, 0x8 ;
/*0470*/ SHFL.UP PT, R16, R17, 0x8, RZ ;
/*0480*/ SEL R16, R16, RZ, P3 ;
/*0490*/ ISETP.NE.AND P3, PT, R14, 0x1f, PT ;
/*04a0*/ LOP3.LUT R16, R17, R16, RZ, 0x3c, !PT ;
/*04b0*/ SHFL.UP PT, R15, R16, 0x10, RZ ;
/*04c0*/ @!P3 SHF.R.U32.HI R17, RZ, 0x3, R6 ;
/*04d0*/ @!P3 LOP3.LUT R17, R17, 0x1ffffffc, RZ, 0xc0, !PT ;
/*04e0*/ SEL R15, R15, RZ, P4 ;
/*04f0*/ LOP3.LUT R24, R16, R15, RZ, 0x3c, !PT ;
/*0500*/ LOP3.LUT R15, R19, 0x7c, RZ, 0xc0, !PT ;
/*0510*/ SHF.R.U32.HI R19, RZ, 0x5, R6 ;
/*0520*/ @!P3 STS [R17+UR4], R24 ;
/*0530*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;
/*0540*/ ISETP.GE.U32.AND P4, PT, R14, R19, PT ;
/*0550*/ ISETP.NE.AND P5, PT, R19, RZ, PT ;
/*0560*/ LDS R20, [R15+UR4] ;
/*0570*/ SEL R22, R20, RZ, !P4 ;
/*0580*/ REDUX.XOR UR8, R20 ;
/*0590*/ REDUX.XOR UR5, R22 ;
/*05a0*/ IMAD.U32 R17, RZ, RZ, UR8 ;
/*05b0*/ LOP3.LUT R16, R17, R10, RZ, 0x3c, !PT ;
/*05c0*/ IMAD.U32 R14, RZ, RZ, UR5 ;
/*05d0*/ SEL R19, R14, RZ, P5 ;
/*05e0*/ IMAD.IADD R14, R12, 0x1, R0 ;
/*05f0*/ LOP3.LUT R19, R10, R24, R19, 0x96, !PT ;
/*0600*/ ISETP.GE.AND P6, PT, R14, 0x20, PT ;
/*0610*/ SHF.R.U32.HI R24, RZ, R12, R11 ;
/*0620*/ STG.E desc[UR6][R2.64+-0x1000], R19 ;
/*0630*/ @!P6 BRA 0x700 ;
/*0640*/ VIADD R9, R9, 0x1 ;
/*0650*/ IADD3 R12, -R12, 0x20, RZ ;
/*0660*/ IMAD.MOV.U32 R11, RZ, RZ, RZ ;
/*0670*/ ISETP.GE.AND P6, PT, R9, R0, PT ;
/*0680*/ @P6 BRA 0x6b0 ;
/*0690*/ IMAD.WIDE R10, R9, 0x1000, R4 ;
/*06a0*/ LDG.E.CONSTANT R11, desc[UR6][R10.64] ;
/*06b0*/ SHF.L.U32 R12, R11, R12, RZ ;
/*06c0*/ ISETP.GT.AND P6, PT, R14.reuse, 0x20, PT ;
/*06d0*/ VIADD R14, R14, 0xffffffe0 ;
/*06e0*/ SEL R17, R12, RZ, P6 ;
/*06f0*/ LOP3.LUT R24, R17, R24, RZ, 0xfc, !PT ;
/*0700*/ LOP3.LUT R13, R24, R13, RZ, 0xc0, !PT ;
/*0710*/ VIADD R8, R8, 0x2 ;
/*0720*/ ISETP.NE.AND P6, PT, R21, RZ, PT ;
/*0730*/ SHFL.UP PT, R10, R13, 0x1, RZ ;
/*0740*/ SEL R10, R10, RZ, P0 ;
/*0750*/ ISETP.NE.AND P0, PT, R18, RZ, PT ;
/*0760*/ LOP3.LUT R10, R13, R10, RZ, 0x3c, !PT ;
/*0770*/ SHFL.UP PT, R12, R10, 0x2, RZ ;
/*0780*/ SEL R17, R12, RZ, P1 ;
/*0790*/ LOP3.LUT R17, R10, R17, RZ, 0x3c, !PT ;
/*07a0*/ SHFL.UP PT, R12, R17, 0x4, RZ ;
/*07b0*/ SEL R12, R12, RZ, P2 ;
/*07c0*/ LOP3.LUT R12, R17, R12, RZ, 0x3c, !PT ;
/*07d0*/ SHFL.UP PT, R18, R12, 0x8, RZ ;
/*07e0*/ SEL R19, R18, RZ, P0 ;
/*07f0*/ @!P3 SHF.R.U32.HI R18, RZ, 0x3, R6 ;
/*0800*/ LOP3.LUT R19, R12, R19, RZ, 0x3c, !PT ;
/*0810*/ @!P3 LOP3.LUT R21, R18, 0x1ffffffc, RZ, 0xc0, !PT ;
/*0820*/ ISETP.NE.AND P0, PT, R8, 0x20, PT ;
/*0830*/ SHFL.UP PT, R13, R19, 0x10, RZ ;
/*0840*/ SEL R10, R13, RZ, P6 ;
/*0850*/ LOP3.LUT R18, R19, R10, RZ, 0x3c, !PT ;
/*0860*/ @!P3 STS [R21+UR4+0x80], R18 ;
/*0870*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;
/*0880*/ LDS R15, [R15+UR4+0x80] ;
/*0890*/ SEL R10, R15, RZ, !P4 ;
/*08a0*/ REDUX.XOR UR4, R10 ;
/*08b0*/ IMAD.U32 R12, RZ, RZ, UR4 ;
/*08c0*/ REDUX.XOR UR4, R15 ;
/*08d0*/ SEL R13, R12, RZ, P5 ;
/*08e0*/ LOP3.LUT R17, R16, R18, R13, 0x96, !PT ;
/*08f0*/ IADD3 R18, P1, R2, 0x2000, RZ ;
/*0900*/ STG.E desc[UR6][R2.64], R17 ;
/*0910*/ IMAD.X R19, RZ, RZ, R3, P1 ;
/*0920*/ IMAD.U32 R13, RZ, RZ, UR4 ;
/*0930*/ LOP3.LUT R10, R13, R16, RZ, 0x3c, !PT ;
/*0940*/ @P0 BRA 0x1b0 ;
/*0950*/ EXIT ;
/*0960*/ BRA 0x960;
/*0970*/ NOP;
/*0980*/ NOP;
"""


def test_sass_census_of_a_port_kernel():
    c = roofline.sass_census(XORDELTA_SASS, "_ZN2gt22xordelta_decode_kernelEPKjPKiPji", (16,), LANES, GROUP)
    assert c["loops"] == [(0x1B0, 0x940, 16)] and c["cold_instructions"] == 0
    # 28 instructions outside the loop and 122 in it, a thread of 32 values
    assert c["issue_per_elem"] == (28 + 16 * 122) / 32
    ops = c["ops_per_elem"]
    assert ops["SHFL"] == 16 * 10 / 32 and ops["STG"] == 16 * 2 / 32 and ops["LDG"] == (2 + 16 * 2) / 32
    assert ops["REDUX"] == 16 * 4 / 32 and ops["EXIT"] == 1 / 32
    assert c["unknown_per_elem"] == 0 and not c["has_unbounded_loop"] and not c["loops_mismatch"]
    # the loop's least path skips its two word loads' blocks (12 instructions each)
    assert c["floor_issue_per_elem"] == (28 + 16 * (122 - 24)) / 32


def test_ops_audit_on_the_cpu():
    _, col = _column("delta")
    a = roofline.ops_audit(col, "cpu")
    assert a["interpreted"] is True and a["budget"] is None and a["issue_per_elem"] is None
    assert a["alu_per_elem"] is a["memory_bound"] is a["top_ops_per_elem"] is None
    b = roofline.ops_audit(col, "cpu", H100_SXM)
    assert b["budget"] == roofline.ops_budget(col, H100_SXM) and b["lsu_per_elem"] is None
    assert (b["scheme"], b["n"], b["n_pad"]) == ("delta", N, N)


def test_scan_walk_trips():
    """walk_tiles' loops as the wrappers declare them: the barrier loop's
    three forms add up to the stages, a block issues each tile once."""
    for stages in range(2, 17):
        t16, t4, t1 = _wrap.init_trips(stages)
        whole = stages - stages % 4 if stages >= 4 else 0
        assert 16 * t16 + (8 if whole - 16 * t16 > 4 else 0) + 4 * t4 + t1 == stages
    ng, bits, stages, grid = 40, 9, 6, 37
    trips = _wrap.walk_trips(ng, bits, False, stages, grid)
    assert len(trips) == 21 and trips[3] == stages - 1 and trips[12] == ng * 4 / grid
    tiles = ng * 4
    issued = sum(min(-(-(tiles - b) // grid), stages - 1) for b in range(grid))
    issued += sum(max(0, -(-(tiles - b) // grid) - stages + 1) for b in range(grid))
    assert issued == tiles  # every tile's copies, once
    # warp 0 of 8 starts 9 copies (lanes 0..8) a tile
    assert trips[4] * 8 * (stages - 1) * grid + trips[13] * 8 * tiles == pytest.approx(9 * tiles)
    assert trips[5] == trips[14] == 0 and _wrap.walk_trips(ng, 32, True, 2, grid)[5] > 0


@pytest.mark.parametrize("tiles", [1, 4, 32, 64])
def test_run_filter_census(tiles):
    """K19's census from the call's shapes (no kernel, so on the CPU too):
    the instance by kind and op, blocks of 8 warps, a warp a quarter group
    (ng = 3: 12 warps in 2 blocks), the tiles a warp visits (T, or the 32
    of its half of the lanes at W = 512) averaged over the warps launched,
    and the flip loops (XORed in; slots, rounds of marks), whose trips are
    data."""
    from giddy_tpu_torch.kernels import run_filter

    from test_torch_inputs import run_tables

    ends, vals = run_tables("random", 16, tiles, 3)
    args = (torch.from_numpy(ends), torch.from_numpy(vals), None, 3, "f", 4, "ge", 0)
    (launch,) = run_filter.census("run_filter", args)
    assert launch.kernel == "gt::run_filter_kernel<(gt::Kind)2, (gt::Op)5>"
    assert launch.threads == 2 * 8 * 32
    assert launch.trips == ((32 if tiles == 64 else tiles) * 12 / 16, None, None, None)


def test_loop_trip_helpers():
    assert _wrap.strided_trips(8) == 1 / 32 and _wrap.strided_trips(1024) == 1
    assert _wrap.strided_trips(2049) == (32 * 2 + 1) / 32
    assert _wrap.exception_trips(0, 4) == (0, 0)
    assert _wrap.exception_trips(1000, 4) == (10 / 32, 1000 / 32 / 128)


WITHOUT_TABLE = ["nbit", "dzbf", "for", "delta", "delta2", "xordelta", "rle", "rpe", "patched", "model", "bitmap",
                 "alp", "dzbv"]


@pytest.mark.parametrize("scheme", WITHOUT_TABLE)
def test_wrapper_census_of_a_column(scheme):
    """Each wrapper's census of the call that decodes a column (computed
    from the call's shapes; no kernel, so on the CPU too): the instance's
    name, a block of 1024 threads a group, the declared loop trips."""
    from giddy_tpu_torch import api, kernels

    _, col = _column(scheme)
    name, args = kernels.kernel_call(col, api.device_streams(col, "cpu"), api.narrow_store_dtype(col))
    (launch,) = kernels.WRAPPERS[name].census(name, args)
    assert launch.threads == N // GROUP * LANES
    kernel = launch.kernel.split("<")[0]
    if scheme in ("rle", "rpe"):
        ends = args[0]
        span = min(N // ends.shape[0], 1024)
        assert kernel == "gt::run_strip_kernel" and launch.trips == (1024 // span, span // 128)
        assert launch.kernel.endswith(f"(int){max(1, ends.shape[1] // 32)}>")
    elif scheme in ("patched", "alp"):  # the exception positions are the third, or alp's fourth, argument
        assert launch.trips == _wrap.exception_trips(args[2 if scheme == "patched" else 3].shape[0], N // GROUP)
    elif scheme == "bitmap":
        d = args[1].shape[0]
        assert kernel == "gt::bitmap_decode_kernel" and launch.trips == (d // 4, d % 4)
    elif scheme == "dzbv":
        top = max(k + 1 for k, t in enumerate(args[2]) if t is not None)
        assert launch.kernel.endswith(f"(int){top}>") and len(launch.trips) == 2 * top + 2
        assert launch.trips[-2] == 8 and all(t > 0 for t in launch.trips)
    else:
        want = {"nbit": ("gt::lmp_unpack_kernel", ()), "dzbf": ("gt::lmp_unpack_kernel", ()),
                "for": ("gt::for_unpack_kernel", ()), "delta": ("gt::delta_decode_kernel", (16,)),
                "delta2": ("gt::delta2_decode_kernel", (2,)), "xordelta": ("gt::xordelta_decode_kernel", (16,)),
                "model": ("gt::model_decode_kernel", ())}[scheme]
        assert (kernel, launch.trips) == want
