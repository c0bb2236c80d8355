// The whole-model decode step K9 at head dim 256 (Falcon3's) for 1 to 8
// query heads a kv head: the body is megakernel.cuh, whose header says what
// differs at this head dim (attention items of 64 cache columns, one buffer
// of RoPE columns); megakernel.cu and megakernel_d128.cu build 64 and 128,
// so they compile side by side.
#define MEGAKERNEL_HD 256
#include "megakernel.cuh"
