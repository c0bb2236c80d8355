// The whole-model decode step K9 at every head dim hd % 4 == 0 with
// 32 < hd <= 128 outside 64 and 128, for 9 to 16 query heads a kv head: the
// body is megakernel.cuh, built with MEGAKERNEL_PAD and MEGAKERNEL_WIDE;
// megakernel_dpad.cu builds 1 to 8 there, so the two compile side by side.
#define MEGAKERNEL_PAD
#define MEGAKERNEL_WIDE
#define MEGAKERNEL_HD 128
#include "megakernel.cuh"
