// Phymm bank walk: total log-prob of each read under each bank ICM (Hopper).
//
// Replaces the Pallas TPU kernel glimmer_mg_tpu/ops/icm_pallas.py
// _walk_kernel (launched by bank_score_reads_pallas). Computes exactly the
// function of the plain PyTorch twin
// glimmer_mg_torch/ops/icm_score.py::bank_score_reads_packed:
//
//   out[row, m] = (1/256) * sum over i < len[row] of q(m, row, i)
//
// where q is the int16 fixed-point log-prob of read position i under frame
// i % 3 of bank model m (frame 0 at base 0, cycling), read from the tables
// of glimmer_mg_torch/ops/icm_cuda.py::pack_tables:
//   level_mip (M, 3, LR, 128) int32: walk level k's mut_info_pos entries at
//     rows off_k.., node o = node - (4^k - 1)/3 at row off_k + (o >> 7),
//     lane o & 127;
//   probs_pk (M, 3, R2, 128) int32: two int16 values per entry, base `last`
//     of node n at row (n >> 7)*2 + (last >> 1), lane n & 127, half last & 1;
//     pruned nodes already carry their parent's values.
// The walk: node = 4*node + base + 1 while mut_info_pos[node] >= threshold
// (max(0, model_len-1-i), partial windows at the read start), for at most
// depth levels.
//
// Exact sums. The values are summed as int32 and converted once, so the
// result is the JAX kernel's f32 sum of q/256 to the last bit while
// |score| < 65,536 (every partial sum is then exact in f32).
//
// Design. A grid of (read tile, model), model-major (blockIdx.x, the read
// tile, varies fastest), so one model's tables stay in L2 while its read
// tiles run; one warp per read, lanes striding over positions; each lane
// builds its 11-base context from the read row (2 bits a base) and walks;
// a warp shuffle reduction and one write per (read, model). The TPU
// kernel's frame-phase split, (S, 128) blocks and select-loop gathers are
// gone: a thread reads the tables directly.
//
// Bound on this card: latency of the depth + 1 (<= 8) dependent loads of
// one walk from L2 (one (model, frame) table is 198,656 B: 46 level rows +
// 342 prob rows of 512 B; the whole model 595,968 B). Staging a (model,
// frame) table in a block's 227 KB of shared memory, and walking both
// strands in one launch, is where a faster version starts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;

__global__ void bank_walk_kernel(const int32_t* __restrict__ level_mip,
                                 const int32_t* __restrict__ probs_pk,
                                 const int32_t* __restrict__ reads,
                                 const int32_t* __restrict__ lengths,
                                 float* __restrict__ out, int B, int L, int M,
                                 int LR, int R2, int model_len, int depth) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  const int m = blockIdx.y;
  if (row >= B) return;  // the whole warp leaves together

  const int32_t* read = reads + static_cast<int64_t>(row) * L;
  const int len = lengths[row];
  const int w = model_len - 1;
  int32_t sum = 0;
  for (int i = lane; i < len; i += 32) {
    // packed context: window position k holds the base at i - w + k
    uint32_t ctx = 0;
    for (int k = 0; k < w; ++k) {
      const int j = i - w + k;
      if (j >= 0) ctx |= static_cast<uint32_t>(__ldg(read + j)) << (2 * k);
    }
    const int thresh = max(0, w - i);
    const int f = i % 3;
    const int64_t tab = static_cast<int64_t>(m) * 3 + f;
    const int32_t* lm = level_mip + tab * LR * kLanes;
    int node = 0;
    int row_off = 0;  // first row of level k
    int base = 0;     // (4^k - 1) / 3, the first node of level k
    int width = 1;    // 4^k, the nodes of level k
    for (int k = 0; k < depth; ++k) {
      const int pos = __ldg(lm + row_off * kLanes + (node - base));
      if (pos < thresh) break;
      node = 4 * node + static_cast<int>((ctx >> (2 * pos)) & 3u) + 1;
      row_off += max(1, (width + kLanes - 1) / kLanes);
      base += width;
      width *= 4;
    }
    const int last = __ldg(read + i);
    const int32_t* pk = probs_pk + tab * R2 * kLanes;
    const int32_t acc =
        __ldg(pk + ((node >> 7) * 2 + (last >> 1)) * kLanes + (node & 127));
    sum += (last & 1) ? (acc >> 16)
                      : static_cast<int32_t>(static_cast<int16_t>(acc & 0xFFFF));
  }
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    out[static_cast<int64_t>(row) * M + m] =
        static_cast<float>(sum) * (1.0f / 256.0f);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). out is (B, M) f32. Returns the
// launch's cudaError_t.
extern "C" int gmt_bank_walk(const void* level_mip, const void* probs_pk,
                             const void* reads, const void* lengths, void* out,
                             int B, int L, int M, int LR, int R2,
                             int model_len, int depth, void* stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock, M);
  bank_walk_kernel<<<grid, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(level_mip),
      static_cast<const int32_t*>(probs_pk),
      static_cast<const int32_t*>(reads), static_cast<const int32_t*>(lengths),
      static_cast<float*>(out), B, L, M, LR, R2, model_len, depth);
  return static_cast<int>(cudaGetLastError());
}
