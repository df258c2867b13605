"""The port's kernel build on the host, without a CUDA toolkit: the cache
of built libraries with their ptxas reports (a stand-in ``nvcc`` writes the
library), and the FP32 count of a kernel loop in a ``cuobjdump -sass``
listing (synthetic listings in the tool's two ways of naming a branch
target)."""

import sys
from pathlib import Path

import pytest

from multimodal_hand_pose_enhancement_for_sign_language_tpu_torch.ops import build

REPORT = "ptxas info    : Used 40 registers, 0 bytes spill stores, 0 bytes spill loads"


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """csrc/ with two sources, an empty build directory, and an ``nvcc`` that
    prints a ptxas report, writes its ``-o`` file and logs each call; with
    ``FAIL`` in a source it prints an error and exits 1; ``--version``
    prints a version line and is not logged."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// kernel {name}\n")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "if sys.argv[1:] == ['--version']:\n"
        "    print('stand-in nvcc, release 0.0'); sys.exit(0)\n"
        "src = sys.argv[-1]\n"
        f"open({str(calls)!r}, 'a').write(src + '\\n')\n"
        "if 'FAIL' in open(src).read():\n"
        "    print('error: bad source'); sys.exit(1)\n"
        f"print({REPORT!r})\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "build_log", {})
    monkeypatch.setattr(build, "_tool", lambda name: str(nvcc))
    return csrc, calls


def _calls(calls):
    return calls.read_text().splitlines() if calls.exists() else []


def test_build_compiles_each_source_once_and_keeps_its_report(fake_toolkit):
    csrc, calls = fake_toolkit
    build.build("a", "b")
    assert sorted(_calls(calls)) == [str(csrc / "a.cu"), str(csrc / "b.cu")]
    for name in ("a", "b"):
        assert build.build_log[name]["seconds"] >= 0
        assert REPORT in build.build_log[name]["ptxas"]
        assert build.library(name).exists()


def test_build_reads_the_report_back_for_a_library_built_earlier(
        fake_toolkit, monkeypatch):
    """A second process finds the library and its report: no nvcc, and the
    report (which a spill check reads) is the one of the build."""
    _, calls = fake_toolkit
    build.build("a")
    monkeypatch.setattr(build, "build_log", {})
    build.build("a")
    assert len(_calls(calls)) == 1
    assert build.build_log["a"] == {"seconds": None,
                                    "ptxas": f"{REPORT}\n"}


def test_build_rebuilds_a_library_without_its_report(fake_toolkit, monkeypatch):
    _, calls = fake_toolkit
    build.build("a")
    Path(f"{build.library('a')}.ptxas").unlink()
    monkeypatch.setattr(build, "build_log", {})
    build.build("a")
    assert len(_calls(calls)) == 2
    assert build.build_log["a"]["seconds"] is not None


def test_build_raises_on_a_failed_source_and_keeps_the_other(fake_toolkit):
    csrc, _ = fake_toolkit
    (csrc / "b.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match="nvcc failed for b.cu"):
        build.build("a", "b")
    assert build.library("a").exists() and not build.library("b").exists()
    assert "b" not in build.build_log


def test_an_edited_source_builds_a_new_library(fake_toolkit):
    csrc, calls = fake_toolkit
    build.build("a")
    first = build.library("a")
    (csrc / "a.cu").write_text("// kernel a, edited\n")
    build.build("a")
    assert build.library("a") != first and len(_calls(calls)) == 2


def _listing(functions, labels):
    """A ``cuobjdump -sass`` listing: ``functions`` maps a name to its
    instructions, where ``("loop", i)`` marks a backward branch to the i-th
    instruction; with ``labels`` the targets are named as ``.L_x_N``."""
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a", "",
             "\tcode for sm_90a"]
    for name, instrs in functions.items():
        lines.append(f"\t\tFunction : {name}")
        lines.append('\t.headerflags\t@"EF_CUDA_SM90"')
        targets = {i for ins in instrs if isinstance(ins, tuple) for i in ins[1:]}
        for i, ins in enumerate(instrs):
            if labels and i in targets:
                lines.append(f".L_x_{i}:")
            if isinstance(ins, tuple):
                to = f"`(.L_x_{ins[1]})" if labels else hex(16 * ins[1])
                ins = f"@!P0 BRA {to}"
            lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                         "   /* 0x000fe40000000800 */")
            lines.append("                                          "
                         "   /* 0x000fe40000000800 */")
    return "\n".join(lines) + "\n"


SHFL = "SHFL.DOWN PT, R5, R6, 0x1, R7"
# the loop of the function of interest, unrolled twice: 2 SHFL.DOWN and 8
# FP32 instructions (FADD, FFMA, FMUL, FADD32I) a pass, 4 a cycle; FP32 work
# before and after it, a loop without shuffles, and an outer loop around it
KERNEL = [
    "FADD R1, R2, R3", "FMUL R1, R2, R3",
    "FFMA R1, R2, R3, R4", "IADD3 R1, R2, R3, RZ", ("loop", 2),
    SHFL, "FFMA R1, R2, R3, R4", "FADD.FTZ R1, R2, R3", "FMUL R1, R2, R3",
    "IMAD R1, R2, R3, R4", "FFMA R1, R2, R3, R4", SHFL, "FFMA R1, R2, R3, R4",
    "FADD32I R1, R2, 1", "FFMA R1, R2, R3, R4", "FADD R1, R2, R3", ("loop", 5),
    "FMNMX R1, R2, R3, PT", ("loop", 0), "FFMA R1, R2, R3, R4", "EXIT",
]
OTHER = [SHFL, "FFMA R1, R2, R3, R4", ("loop", 0), "EXIT"]


@pytest.mark.parametrize("labels", [False, True])
def test_loop_fp32_per_cycle_counts_one_pass_of_the_named_kernel(labels):
    sass = _listing({"_Z6kernelILb1EEvPf": OTHER, "_Z6kernelILb0EEvPf": KERNEL},
                    labels)
    assert build.loop_fp32_per_cycle(sass, "kernelILb0E", "SHFL.DOWN", 1) == 4.0
    assert build.loop_fp32_per_cycle(sass, "kernelILb0E", "SHFL.DOWN", 3) == 12.0
    assert build.loop_fp32_per_cycle(sass, "kernelILb1E", "SHFL.DOWN", 1) == 1.0


@pytest.mark.parametrize("function,marker,match", [
    ("kernelILb9E", "SHFL.DOWN", "no function"),
    ("kernelILb0E", "SHFL.UP", "no loop"),
])
def test_loop_fp32_per_cycle_refuses_what_it_cannot_find(function, marker, match):
    sass = _listing({"_Z6kernelILb0EEvPf": KERNEL}, labels=False)
    with pytest.raises(ValueError, match=match):
        build.loop_fp32_per_cycle(sass, function, marker, 1)
