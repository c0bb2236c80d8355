// The whole-model decode step K9 at head dim 128 for 9 to 16 query heads a
// kv head (Mistral-Large-2's 12, Llama-3.1-405B's 16): the body is
// megakernel.cuh, built with MEGAKERNEL_WIDE; megakernel_d128.cu builds 1 to
// 8 at this head dim, so the two compile side by side.
#define MEGAKERNEL_WIDE
#define MEGAKERNEL_HD 128
#include "megakernel.cuh"
