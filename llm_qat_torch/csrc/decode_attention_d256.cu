// K3, K7 and K8 at head dim 256 (Falcon3's), for 1 to 4 query heads a kv
// head: the entry points and their device code are decode_attn.cuh's (its
// Smem says why G stops at 4 there); decode_attention.cu says what each
// replaces and builds head dim 64, so the head dims compile side by side.
#define DECODE_ATTN_HD 256
#include "decode_attn.cuh"
