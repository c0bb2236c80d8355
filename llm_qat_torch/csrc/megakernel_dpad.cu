// The whole-model decode step K9 at every head dim hd % 4 == 0 with
// 32 < hd <= 128 outside 64 and 128 (OpenLLaMA-3B's 100): the body is
// megakernel.cuh, built with MEGAKERNEL_PAD (hd from the launch, the
// attention stages' shared memory sized as at 128); megakernel.cu and
// megakernel_d128.cu build 64 and 128, so the three compile side by side.
#define MEGAKERNEL_PAD
#define MEGAKERNEL_HD 128
#include "megakernel.cuh"
