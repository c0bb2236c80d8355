// K3, K7 and K8 at head dim 16 (the entry points and their device code
// are decode_attn.cuh's; decode_attention.cu says what each replaces and
// builds head dim 64, so the head dims compile side by side).
#define DECODE_ATTN_HD 16
#include "decode_attn.cuh"
