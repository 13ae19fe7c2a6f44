// The order in which both flash-attention kernels' blocks start
// (flash_attention.cu, flash_attention_wgmma.cu).
//
// A block computes one query tile of one (batch, head) pair, and the grid
// is one dimension of tiles x pairs, cut into groups of pairs: each pair
// a group of its own, or all pairs one group.  Within a group the query
// tile varies slowest and the pair fastest, causal tiles in reverse
// order, so the group's longest tiles start first and its short ones fill
// the tail.  One group puts every head's longest tiles first: head by
// head, the last heads' longest tiles would start when the other heads
// were nearly done (at 9 heads of 64, S=4096: 288 blocks on 132 SMs).
// But the blocks running at one time then span every head, each K or V
// tile is shared by fewer of them, and it must wait in L2 for the rest of
// its head's query tiles.  The bf16 kernel needs about one byte of K and V
// per 128 flops when no read is shared, more than HBM gives at its rate,
// so it takes one group only where the K and V of every pair fit in
// FLASH_L2_BUDGET together (at 32 heads of 80 and S=32,768, 335 MB, one
// group and even pairs of heads were slower than head by head).  The
// float32 kernel needs one byte per 64 flops at under a tenth of the
// rate, and always takes one group.
#pragma once

// bytes of the H100's 50 MB L2 that the K and V of one group may take
constexpr double FLASH_L2_BUDGET = 32.0 * (1 << 20);

// Pairs per group for the bf16 kernel: all B * H when the K and V of the B
// x KV heads fit in FLASH_L2_BUDGET, else one.
inline int flash_group(int B, int H, int KV, int S, int hd, int elt) {
  const double kv_bytes = 2.0 * B * KV * double(S) * hd * elt;
  return kv_bytes <= FLASH_L2_BUDGET ? B * H : 1;
}

// Block x's batch row b, head h and query tile iq, of nq tiles a pair;
// ``group`` pairs a group (1, or every pair).
__device__ __forceinline__ void flash_tile(int x, int nq, int group, int H,
                                           int causal, int& b, int& h,
                                           int& iq) {
  const int gi = x / (group * nq), r = x % (group * nq);
  const int it = r / group, pair = gi * group + r % group;
  iq = causal ? nq - 1 - it : it;
  h = pair % H;
  b = pair / H;
}
