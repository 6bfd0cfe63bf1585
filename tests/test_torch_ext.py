"""ext.ptxas_summary: nvcc's -Xptxas -v report read per kernel
instantiation. An anonymous namespace's mangling names the source file, so
every kernel of sample_kernel.cu holds "sample_kernel"; the regenerating K1
must still be told from the lockstep one, and the counting K1 from both."""

from rayzen_tpu_torch import ext

_PFX = "_ZN49_GLOBAL__N__9c999aa8_16_sample_kernel_cu_1bedf115"
_TAIL = "EEEvT_PKfS6_S6_S6_PKhiNS1_12SampleParamsEPfPi"
LOG = "\n".join([
    f"ptxas info    : Compiling entry function '{_PFX}12regen_kernelIN2rz8Bvh2Walk"
    f"ENS_9LaneCount{_TAIL}' for 'sm_90a'",
    "ptxas info    : Function properties for x",
    "    448 bytes stack frame, 378 bytes spill stores, 412 bytes spill loads",
    "ptxas info    : Used 64 registers, used 0 barriers, 448 bytes cumulative stack size",
    f"ptxas info    : Compiling entry function '{_PFX}13sample_kernelIN2rz8Bvh2WalkELb1"
    "ELb0EEEvT_PKfS5_S5_S5_PKhiNS1_12SampleParamsEPfPiS9_' for 'sm_90a'",
    "ptxas info    : Function properties for x",
    "    256 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    "ptxas info    : Used 122 registers, used 0 barriers, 256 bytes cumulative stack size",
    f"ptxas info    : Compiling entry function '{_PFX}12regen_kernelIN2rz10TieredWalk"
    f"ENS1_7NoCount{_TAIL}' for 'sm_90a'",
    "ptxas info    : Function properties for x",
    "    768 bytes stack frame, 718 bytes spill stores, 700 bytes spill loads",
    "ptxas info    : Used 64 registers, used 0 barriers, 768 bytes cumulative stack size",
])


def test_ptxas_summary_tells_the_k1_schedules_apart():
    assert ext.ptxas_summary(LOG) == {
        "regen_kernel<Bvh2Walk,count>": {"stack": 448, "spill": 378, "regs": 64},
        "sample_kernel<Bvh2Walk,octant>": {"stack": 256, "spill": 0, "regs": 122},
        "regen_kernel<TieredWalk>": {"stack": 768, "spill": 718, "regs": 64},
    }
