// The whole-model decode step K9 at head dim 128 (the body is
// megakernel.cuh; megakernel.cu builds head dim 64, so the two compile side
// by side).
#define MEGAKERNEL_HD 128
#include "megakernel.cuh"
