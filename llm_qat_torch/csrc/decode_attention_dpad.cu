// K3, K7 and K8 at every head dim hd % 4 == 0 with 32 < hd <= 128 outside
// 64 and 128 (OpenLLaMA-3B's 100; 36..124): the entry points and their
// device code are decode_attn.cuh's, built with DECODE_ATTN_PAD, hd from the
// launch and the shared buffers sized as at head dim 128
// (decode_attention.cu says what each entry replaces).
#define DECODE_ATTN_PAD
#define DECODE_ATTN_HD 128
#include "decode_attn.cuh"
