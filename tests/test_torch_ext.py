"""ext.ptxas_summary: nvcc's -Xptxas -v report read per kernel
instantiation. An anonymous namespace's mangling names the source file, so
every kernel of sample_kernel.cu holds "sample_kernel"; the regenerating K1
must still be told from the lockstep one, the counting K1 forms from both,
the K9 and K6 forms (the lockstep loop with warp tiles) from phase 1's,
and the standalone walks' instantiations (mode, walk, counting; K6's packet
walk by mode and counting) apart."""

from rayzen_tpu_torch import ext
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_PFX = "_ZN49_GLOBAL__N__9c999aa8_16_sample_kernel_cu_1bedf115"
_TAIL = "EEEvT_PKfS6_S6_S6_PKhiNS1_12SampleParamsEPfPi"
_WANON = "_GLOBAL__N__1347192c_15_walk_kernels_cu_1ce61403"
_WPFX = f"_ZN48{_WANON}"
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
    # the K9 and K6 forms of K1 on the warp-tiled lockstep loop
    # (sample_kernel<Walk, kOctant, kFrustum>) and the counting wide K1
    *(line for kernel, walk, rest, regs in (
        ("13sample", "10TieredWalk", "ELb1ELb0", 63),
        ("13sample", "8Bvh2Walk", "ELb0ELb1", 62),
        ("13sample", "8Bvh2Walk", "ELb1ELb1", 61),
        ("13sample", "8Bvh8Walk", "ELb1ELb0", 60),
        ("12regen", "8Bvh8Walk", "ENS_9LaneCount", 59))
      for line in (
        f"ptxas info    : Compiling entry function '{_PFX}{kernel}_kernelIN2rz{walk}"
        f"{rest}{_TAIL}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    512 bytes stack frame, 400 bytes spill stores, 400 bytes spill loads",
        f"ptxas info    : Used {regs} registers, used 0 barriers, 512 bytes "
        "cumulative stack size")),
    # the counting form of the frustum K9 form: the tiled lockstep loop
    # walking through Counted<Walk>, with LaneCount
    f"ptxas info    : Compiling entry function '{_PFX}13sample_kernelINS_7CountedIN2rz"
    "8Bvh2WalkEEELb1ELb1ENS_9LaneCountEEEvT_PKfS8_S8_S8_PKhiNS2_12SampleParams"
    "EPfPiSC_' for 'sm_90a'",
    "ptxas info    : Function properties for x",
    "    640 bytes stack frame, 520 bytes spill stores, 520 bytes spill loads",
    "ptxas info    : Used 64 registers, used 0 barriers, 640 bytes cumulative stack size",
    # the standalone walks (template <int kMode, class Walk, class Count>:
    # 0 closest, 1 shadow): K7 counting and not, K2 through the tiered
    # view, and K4's regenerating phase 1
    *(line for mangled, regs in (
        (f"{_WPFX}16live_walk_kernelILi1EN2rz12MisslinkWalkENS1_48{_WANON}9"
         "LaneCountEEEvT0_NS_6WaveIOEiiiff", 58),
        (f"{_WPFX}16live_walk_kernelILi0EN2rz12MisslinkWalkENS1_7NoCountEEEvT0_"
         "NS_6WaveIOEiiiff", 57),
        (f"{_WPFX}16live_walk_kernelILi0EN2rz10TieredWalkENS1_7NoCountEEEvT0_"
         "NS_6WaveIOEiiiff", 56),
        (f"{_PFX}19regen_phase1_kernelIN2rz8Bvh2WalkENS1_7NoCount{_TAIL}S5_", 55))
      for line in (
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Used {regs} registers, used 0 barriers, 0 bytes "
        "cumulative stack size")),
])


def test_ptxas_summary_tells_the_k1_schedules_apart():
    assert ext.ptxas_summary(LOG) == {
        "regen_kernel<Bvh2Walk,count>": {"stack": 448, "spill": 378, "regs": 64},
        "sample_kernel<Bvh2Walk,octant>": {"stack": 256, "spill": 0, "regs": 122},
        "regen_kernel<TieredWalk>": {"stack": 768, "spill": 718, "regs": 64},
        "sample_kernel<TieredWalk,octant>": {"stack": 512, "spill": 400, "regs": 63},
        "sample_kernel<Bvh2Walk,frustum>": {"stack": 512, "spill": 400, "regs": 62},
        "sample_kernel<Bvh2Walk,octant,frustum>": {"stack": 512, "spill": 400,
                                                   "regs": 61},
        "sample_kernel<Bvh8Walk,octant>": {"stack": 512, "spill": 400, "regs": 60},
        "regen_kernel<Bvh8Walk,count>": {"stack": 512, "spill": 400, "regs": 59},
        "sample_kernel<Bvh2Walk,octant,frustum,count>": {
            "stack": 640, "spill": 520, "regs": 64},
        "live_walk_kernel<shadow,MisslinkWalk,count>": {"stack": 0, "spill": 0,
                                                        "regs": 58},
        "live_walk_kernel<closest,MisslinkWalk>": {"stack": 0, "spill": 0, "regs": 57},
        "live_walk_kernel<closest,TieredWalk>": {"stack": 0, "spill": 0, "regs": 56},
        "regen_phase1_kernel<Bvh2Walk>": {"stack": 0, "spill": 0, "regs": 55},
    }


_CANON = "_GLOBAL__N__5d0e1f2a_23_continuation_kernel_cu_8a3c2b1d"
LOG_LIVE = "\n".join(
    line for mangled, regs in (
        # the live-ray walks: template <int kMode, class Walk, class Count>
        (f"{_WPFX}16live_walk_kernelILi0EN2rz12MisslinkWalkENS1_7NoCountEEEvT0_"
         "NS_6WaveIOEiiiff", 62),
        (f"{_WPFX}16live_walk_kernelILi1EN2rz8Bvh2WalkENS1_48{_WANON}9LaneCountEEEv"
         "T0_NS_6WaveIOEiiiff", 54),
        # K6's packet walk: template <int kMode, class Count>
        (f"{_WPFX}19frustum_walk_kernelILi0EN2rz7NoCountEEEvNS1_6TablesENS_6WaveIO"
         "Eiiiff", 53),
        (f"{_WPFX}19frustum_walk_kernelILi1ENS1_48{_WANON}9LaneCountEEEvN2rz6Tables"
         "ENS_6WaveIOEiiiff", 52),
        # the continuation: template <class Walk, bool kOctant>, and the
        # counting form (the walk through Counted)
        (f"_ZN55{_CANON}19continuation_kernelIN2rz8Bvh2WalkELb0EEEvT_PKfNS_5Split"
         "ENS1_12SampleParamsE", 64),
        (f"_ZN55{_CANON}19continuation_kernelIN2rz8Bvh2WalkELb1EEEvT_PKfNS_5Split"
         "ENS1_12SampleParamsE", 63),
        (f"_ZN55{_CANON}19continuation_kernelIN2rz7CountedINS1_8Bvh2WalkEEELb0EEEv"
         "T_PKfNS_5SplitENS1_12SampleParamsE", 61),
        # K1's K9 form on the lockstep loop: sample_kernel<Walk, kOctant, kFrustum>
        (f"{_PFX}13sample_kernelIN2rz8Bvh2WalkELb1ELb1EEEvT_PKfS5_S5_S5_PKhiNS1_12"
         "SampleParamsEPfPiS9_", 60))
    for line in (
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Used {regs} registers, used 0 barriers, 0 bytes "
        "cumulative stack size"))


def test_ptxas_summary_labels_the_live_walks_and_the_continuation():
    got = ext.ptxas_summary(LOG_LIVE)
    assert {k: v["regs"] for k, v in got.items()} == {
        "live_walk_kernel<closest,MisslinkWalk>": 62,
        "live_walk_kernel<shadow,Bvh2Walk,count>": 54,
        "frustum_walk_kernel<closest>": 53,
        "frustum_walk_kernel<shadow,count>": 52,
        "continuation_kernel<Bvh2Walk>": 64,
        "continuation_kernel<Bvh2Walk,octant>": 63,
        "continuation_kernel<Bvh2Walk,count>": 61,
        "sample_kernel<Bvh2Walk,octant,frustum>": 60,
    }
