"""The SASS report (`repro_torch.kernels.sass`) on a small hand-written
disassembly: parsing, the draw loop's hot path, the count by pipe, and
ptxas's figures by kernel.  The chip smoke run applies it to the real
kernels' disassembly."""
import pytest

from repro_torch.kernels import sass

ENCODING = "/* 0x000fe20000000f00 */"
BODY = [
    ("0000", "MOV R1, c[0x0][0x28]"),
    ("0010", "IADD3 R2, R2, 0x1, RZ"),                   # loop head
    ("0020", "LOP3.LUT R3, R2, R4, RZ, 0x3c, !PT"),
    ("0030", "FFMA R5, R3, R3, R5"),
    ("0040", "MUFU.RSQ R6, R5"),
    ("0050", "@!P0 BRA 0x90"),              # skips a slow path with a loop
    ("0060", "IMAD R7, R7, R7, RZ"),
    ("0070", "@P1 BRA 0x60"),
    ("0080", "I2F R8, R7"),
    ("0090", "ISETP.GE.AND P2, PT, R2, 0x10, PT"),
    ("00a0", "@!P3 BRA 0xc0"),              # skips one plain instruction
    ("00b0", "FADD R9, R9, R5"),
    ("00c0", "@!P2 BRA 0x10"),              # the loop's back edge
    ("00d0", "EXIT"),
]
MANGLED = "_ZN12_GLOBAL__N_110toy_kernelEPf"
SASS = "\n".join(
    ["\tcode for sm_90a", f"\t\tFunction : {MANGLED}",
     '\t.headerflags\t@"EF_CUDA_SM90"']
    + [f"        /*{a}*/                   {ins} ;   {ENCODING}"
       for a, ins in BODY]) + "\n"
PTXAS = f"""ptxas info    : Compiling entry function '{MANGLED}' for 'sm_90a'
ptxas info    : Function properties for {MANGLED}
    16 bytes stack frame, 32 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 2048 bytes smem
"""


def test_parse_reads_predicates_opcodes_and_targets():
    instrs = sass.parse(SASS)[MANGLED]
    assert [i.addr for i in instrs] == [int(a, 16) for a, _ in BODY]
    br = instrs[5]
    assert (br.pred, br.op, br.target()) == ("@!P0", "BRA", 0x90)
    assert instrs[2].base == "LOP3" and instrs[2].target() is None


def test_hot_path_skips_slow_paths_and_keeps_plain_branches():
    instrs = sass.parse(SASS)[MANGLED]
    path = sass.draw_loop(instrs)
    assert [hex(i.addr) for i in path] == [
        "0x10", "0x20", "0x30", "0x40", "0x50", "0x90", "0xa0", "0xb0",
        "0xc0"]


def test_report_counts_per_draw_by_pipe_and_ptxas_figures():
    rec = sass.analyse(SASS, PTXAS)["toy_kernel"]
    assert rec["draws_per_iteration"] == 1
    assert rec["per_draw_by_pipe"] == {"alu": 3.0, "control": 3.0,
                                       "fma": 2.0, "xu": 1.0}
    assert rec["cycles_per_draw"] == pytest.approx({
        "alu": 3 / 64, "fmaheavy": 0.0, "fma": 2 / 128, "xu": 1 / 16,
        "issue": 9 / 128})
    assert (rec["registers"], rec["stack_bytes"], rec["spill_store_bytes"],
            rec["spill_load_bytes"]) == (40, 16, 32, 24)
    assert rec["local_memory_instructions"] == 0


@pytest.mark.parametrize("mangled, name", [
    (MANGLED, "toy_kernel"),
    ("_Z16fused_mac_kernelPKjPKf", "fused_mac_kernel"),
    ("_ZN45_GLOBAL__N__4a4380cc_12_fused_mac_cu_dafd982021"
     "fused_partials_kernelEPKj", "fused_partials_kernel"),
])
def test_short_name(mangled, name):
    assert sass.short_name(mangled) == name


@pytest.mark.parametrize("mangled, name", [
    (MANGLED, "toy_kernel"),
    ("_ZN51_GLOBAL__N__4293d5e8_18_flash_attn_tf32_cu_2c51640917"
     "flash_tf32_kernelILi128EEEv14CUtensorMap_stS1_PKfPfiiiiiNS_6Layout"
     "ES5_fi", "flash_tf32_kernel<128>"),
    ("_ZN12_GLOBAL__N_117flash_attn_kernelILi32EfEEvPKT0_",
     "flash_attn_kernel<32, float>"),
    ("_ZN12_GLOBAL__N_117flash_attn_kernelILi16E13__nv_bfloat16EEvPKT0_",
     "flash_attn_kernel<16, __nv_bfloat16>"),
    ("_ZN51_GLOBAL__N__4293d5e8_18_flash_attn_tf32_cu_2c51640917"
     "flash_tf32_kernelILi32ELi16EEEv14CUtensorMap_stS1_PKfPfiiiiiNS_6Layout"
     "ES5_fi", "flash_tf32_kernel<32, 16>"),
    ("_ZN52_GLOBAL__N__5f6c4d44_19_flash_attn_wgmma_cu_18bb9c5118"
     "flash_wgmma_kernelILi16EEEv14CUtensorMap_stS1_PK13__nv_bfloat16PS2_"
     "iiiiNS_6LayoutES6_fi", "flash_wgmma_kernel<16>"),
])
def test_instance_name_keeps_template_arguments(mangled, name):
    assert sass.instance_name(mangled) == name


def test_report_keeps_each_template_instance():
    two = "\n".join(
        SASS.replace(MANGLED, f"_ZN12_GLOBAL__N_110toy_kernelILi{hd}EEvPf")
        for hd in (64, 128))
    assert set(sass.analyse(two)) == {"toy_kernel<64>", "toy_kernel<128>"}


def test_a_function_without_a_draw_has_no_draw_loop():
    text = SASS.replace("MUFU.RSQ", "MUFU.EX2")
    assert "cycles_per_draw" not in sass.analyse(text)["toy_kernel"]
