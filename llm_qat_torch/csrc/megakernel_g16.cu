// The whole-model decode step K9 at head dim 64 for 9 to 16 query heads a kv
// head (the body is megakernel.cuh, built with MEGAKERNEL_WIDE; megakernel.cu
// builds 1 to 8 at this head dim, so the two compile side by side).
#define MEGAKERNEL_WIDE
#define MEGAKERNEL_HD 64
#include "megakernel.cuh"
