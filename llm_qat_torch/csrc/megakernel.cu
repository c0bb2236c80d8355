// The whole-model decode step K9 at head dim 64 (the body is megakernel.cuh;
// megakernel_d128.cu builds head dim 128, so the two compile side by side).
#define MEGAKERNEL_HD 64
#include "megakernel.cuh"
