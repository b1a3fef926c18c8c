// Phymm bank walk: total log-prob of each read under each bank ICM (Hopper).
//
// Replaces the Pallas TPU kernel glimmer_mg_tpu/ops/icm_pallas.py
// _walk_kernel (launched by bank_score_reads_pallas at its pl.pallas_call),
// both table formats: fixed16 (pack_tables) and int8 (pack_tables_int8).
// Computes exactly the function of the plain PyTorch twin
// glimmer_mg_torch/ops/icm_score.py::bank_score_reads_packed:
//
//   out[row, m] = (1/scale) * sum over i < len[row] of q(m, row, i)
//
// where q is the fixed-point log-prob of read position i under frame i % 3
// of bank model m (frame 0 at base 0, cycling), read from the tables of
// glimmer_mg_torch/ops/icm_cuda.py::pack_tables or ::pack_tables_int8:
//   level_mip (M, 3, LR, 128) int32: walk level k's mut_info_pos entries at
//     rows off_k.., node o = node - (4^k - 1)/3 at row off_k + (o >> 7),
//     lane o & 127;
//   probs_pk, fixed16: (M, 3, R2, 128) int32 holding two int16 values,
//     base `last` of node n at row (n >> 7)*2 + (last >> 1), lane n & 127,
//     half last & 1; int8: (M, 3, R, 128) int32 holding four int8 values,
//     base `last` of node n at row n >> 7, lane n & 127, byte last.
//     Pruned nodes already carry their parent's values.
// The walk: node = 4*node + base + 1 while mut_info_pos[node] >= threshold
// (max(0, model_len-1-i), partial windows at the read start), for at most
// depth levels. With two strands the result is the per-(read, model) max
// of the forward read's total and its reverse complement's.
//
// Exact sums. The values are summed as int32 and converted once, so kernel
// and twin are bitwise equal, and equal to the JAX kernel's f32 sum of
// q/scale while every partial f32 sum is exact (|score| < 65,536 for
// fixed16 at scale 256; always for int8 at scale 8).
//
// Bound on this card. The function reads its packed tables once (305.1 MB
// for 512 depth-7 models in fixed16, 0.091 ms at 3.35 TB/s) but walks
// every (position, model, strand): at B 512 x L 702 x M 512 with reads of
// 300/500/700 bp that is 262 M walks entering 1.81 G levels, each level a
// dependent table read. The SASS of walk_kernel<false, 7> (cuobjdump -sass,
// sm_90a) issues 7 integer instructions per level and 22 per walk outside
// the levels (field prefetch, context mask, threshold, prob address, sum,
// loop control): 18.4 G integer instructions, 1.10 ms over 64 INT32 lanes
// x 132 SMs x 1.98 GHz. The integer issue rate bounds it, not the bytes.
//
// Design, against that bound:
//   * prep_kernel computes the model-independent fields once per batch and
//     strand: the packed (model_len-1)-base context and the last base of
//     every position, for the forward reads and their reverse complements,
//     stored frame-major so a warp reads one frame's positions of one read
//     contiguously. No walk loads a base or packs a context.
//   * walk_kernel: one block per (read chunk, model, frame) stages that
//     (model, frame) table (fixed16 46 + 342 rows x 512 B = 198,656 B,
//     int8 46 + 171 rows = 111,104 B) in dynamic shared memory with 16-byte
//     cp.async copies, once, then walks every position i = f (mod 3) of
//     every read of its chunk, both strands, against shared memory only. A
//     warp takes one (read, strand) at a time, lanes stride over positions
//     and prefetch the next position's field. The walk is unrolled to its
//     depth (a template argument), branch-free (a stopped walk keeps its
//     node), with the level offsets as constants: no divergence and few
//     instructions a level, since instructions are the bound.
//   * Each warp writes its int32 partial sum of one (strand, frame, read,
//     model) once; finish_kernel adds the three frames in a fixed order,
//     converts once (x 1/scale) and takes the forward/reverse max. No
//     atomics, so the result does not depend on block order.
// Blocks of one (model, frame) table are adjacent in launch order, so a
// table staged by several read chunks is read from HBM once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxDepth = 7;       // deepest walk that fits shared memory
constexpr int kWarps = 32;         // warps of a walk block
constexpr int kRowsPerBlock = 512; // reads of a walk block (all its strands)
constexpr int kSmemLimit = 232448; // dynamic shared memory of one block

__host__ __device__ constexpr int level_rows(int k) {
  return (1 << (2 * k)) > kLanes ? ((1 << (2 * k)) + kLanes - 1) / kLanes : 1;
}

// Index of node n's mut_info_pos in a staged level table is
// level_start(k) + n for a node of level k: off_k * 128 - (4^k - 1)/3.
// Written out so that it folds to a constant in the unrolled walk.
__host__ __device__ constexpr int level_start(int k) {
  return k == 0 ? 0 : k == 1 ? 127 : k == 2 ? 251 : k == 3 ? 363 : 427;
}

__host__ __device__ constexpr int level_start_from_rows(int k) {
  int off = 0;
  for (int j = 0; j < k; ++j) off += level_rows(j);
  return off * kLanes - ((1 << (2 * k)) - 1) / 3;
}

constexpr bool level_starts_match() {
  for (int k = 0; k < kMaxDepth; ++k) {
    if (level_start(k) != level_start_from_rows(k)) return false;
  }
  return true;
}
static_assert(level_starts_match(), "level_start must follow level_rows");

__host__ __device__ constexpr int level_table_rows(int depth) {
  int rows = 0;
  for (int j = 0; j < depth; ++j) rows += level_rows(j);
  return rows;
}

// rows of the prob table a walk of `depth` levels can reach
__host__ __device__ constexpr int prob_table_rows(int depth, bool int8) {
  return (((1 << (2 * (depth + 1))) - 1) / 3 + kLanes - 1) / kLanes *
         (int8 ? 1 : 2);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// fields[(s*3 + i%3), row, i/3] = ctx | last << 30 for i < len[row], else 0,
// where strand s = 0 is the read and s = 1 its reverse complement.
__global__ void prep_kernel(const int32_t* __restrict__ reads,
                            const int32_t* __restrict__ lengths,
                            uint32_t* __restrict__ fields, int B, int L,
                            int strands, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(strands) * B * L) return;
  const int i = static_cast<int>(idx % L);
  const int row = static_cast<int>((idx / L) % B);
  const int s = static_cast<int>(idx / (static_cast<int64_t>(L) * B));
  const int len = lengths[row];
  const int32_t* read = reads + static_cast<int64_t>(row) * L;
  uint32_t field = 0;
  if (i < len) {
    // window position k holds the base at i - w + k (zeros before 0)
    for (int k = 0; k < w; ++k) {
      const int j = i - w + k;
      if (j < 0) continue;
      const int b = s == 0 ? read[j] : 3 - read[len - 1 - j];
      field |= static_cast<uint32_t>(b) << (2 * k);
    }
    const int last = s == 0 ? read[i] : 3 - read[len - 1 - i];
    field |= static_cast<uint32_t>(last) << 30;
  }
  const int L3 = L / 3;
  fields[(static_cast<int64_t>(s * 3 + i % 3) * B + row) * L3 + i / 3] = field;
}

// fixed-point value of base `last` at `node` in a staged prob table
template <bool kInt8>
__device__ __forceinline__ int prob(const int32_t* s_pk, int node, int last) {
  if (kInt8) {
    return reinterpret_cast<const int8_t*>(s_pk)[4 * node + last];
  }
  return reinterpret_cast<const int16_t*>(s_pk)
      [(((node >> 7) * 2 + (last >> 1)) << 8) + ((node & 127) << 1) +
       (last & 1)];
}

template <bool kInt8, int kDepth>
__global__ void __launch_bounds__(kWarps * 32, 1)
    walk_kernel(const int32_t* __restrict__ level_mip,
                const int32_t* __restrict__ probs_pk,
                const uint32_t* __restrict__ fields,
                const int32_t* __restrict__ lengths,
                int32_t* __restrict__ partial, int B, int L3, int M, int LR,
                int R2, int strands, int w) {
  constexpr int lm_ints = level_table_rows(kDepth) * kLanes;
  constexpr int pk_ints = prob_table_rows(kDepth, kInt8) * kLanes;
  extern __shared__ int4 smem4[];
  const int32_t* s_lm = reinterpret_cast<const int32_t*>(smem4);
  const int32_t* s_pk = s_lm + lm_ints;
  const int tab = blockIdx.y;  // m * 3 + f
  const int m = tab / 3;
  const int f = tab - 3 * m;

  const int4* g_lm = reinterpret_cast<const int4*>(
      level_mip + static_cast<int64_t>(tab) * LR * kLanes);
  const int4* g_pk = reinterpret_cast<const int4*>(
      probs_pk + static_cast<int64_t>(tab) * R2 * kLanes);
  for (int v = threadIdx.x; v < lm_ints / 4; v += blockDim.x) {
    cp_async16(smem4 + v, g_lm + v);
  }
  for (int v = threadIdx.x; v < pk_ints / 4; v += blockDim.x) {
    cp_async16(smem4 + lm_ints / 4 + v, g_pk + v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, B - row0);
  const uint32_t ctx_mask = (1u << (2 * w)) - 1u;
  for (int q = warp; q < rows * strands; q += kWarps) {
    const int s = q / rows;
    const int row = row0 + (q - s * rows);
    const int len = lengths[row];
    const int n = len > f ? (len - f + 2) / 3 : 0;  // positions 3j + f < len
    const uint32_t* fld =
        fields + (static_cast<int64_t>(s * 3 + f) * B + row) * L3;
    int32_t sum = 0;
    uint32_t next = lane < n ? __ldg(fld + lane) : 0u;
    for (int j = lane; j < n; j += 32) {
      const uint32_t ctx = next & ctx_mask;
      const int last = static_cast<int>(next >> 30);
      next = j + 32 < n ? __ldg(fld + j + 32) : 0u;  // the next position's
      const int thresh = max(0, w - (3 * j + f));
      int node = 0;
      bool go = true;
      // A walk that stopped keeps its node; its later reads land inside
      // the staged level table (level_start(k) + node >= 0 for a node of
      // a shallower level) and are discarded. The funnel shift takes its
      // count mod 32, so a negative mut_info_pos shifts harmlessly.
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int pos = s_lm[level_start(k) + node];
        go = go && pos >= thresh;
        const int b =
            static_cast<int>(__funnelshift_r(ctx, 0u, 2 * pos) & 3u);
        node = go ? 4 * node + b + 1 : node;
      }
      sum += prob<kInt8>(s_pk, node, last);
    }
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      partial[(static_cast<int64_t>(s * 3 + f) * B + row) * M + m] = sum;
    }
  }
}

// out[row, m] = max over strands of (sum of the 3 frame partials) / scale
__global__ void finish_kernel(const int32_t* __restrict__ partial,
                              float* __restrict__ out, int64_t BM,
                              int strands, float inv_scale) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= BM) return;
  const int32_t fwd = partial[idx] + partial[BM + idx] + partial[2 * BM + idx];
  float r = static_cast<float>(fwd) * inv_scale;
  if (strands == 2) {
    const int32_t rev =
        partial[3 * BM + idx] + partial[4 * BM + idx] + partial[5 * BM + idx];
    r = fmaxf(r, static_cast<float>(rev) * inv_scale);
  }
  out[idx] = r;
}

template <bool kInt8, int kDepth>
int launch_walk(const int32_t* lm, const int32_t* pk, const uint32_t* fields,
                const int32_t* lengths, int32_t* partial, int B, int L3,
                int M, int LR, int R2, int strands, int w,
                cudaStream_t stream) {
  constexpr int smem =
      (level_table_rows(kDepth) + prob_table_rows(kDepth, kInt8)) * kLanes *
      4;
  static_assert(smem <= kSmemLimit, "table too large for shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<kInt8, kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock, M * 3);
  walk_kernel<kInt8, kDepth><<<grid, kWarps * 32, smem, stream>>>(
      lm, pk, fields, lengths, partial, B, L3, M, LR, R2, strands, w);
  return static_cast<int>(cudaGetLastError());
}

// the walk of `depth` levels (0..kMaxDepth), unrolled at compile time
template <bool kInt8>
int launch_walk_depth(int depth, const int32_t* lm, const int32_t* pk,
                      const uint32_t* fields, const int32_t* lengths,
                      int32_t* partial, int B, int L3, int M, int LR, int R2,
                      int strands, int w, cudaStream_t st) {
  switch (depth) {
#define GMT_DEPTH_CASE(d)                                                   \
  case d:                                                                   \
    return launch_walk<kInt8, d>(lm, pk, fields, lengths, partial, B, L3, M, \
                                 LR, R2, strands, w, st);
    GMT_DEPTH_CASE(0)
    GMT_DEPTH_CASE(1)
    GMT_DEPTH_CASE(2)
    GMT_DEPTH_CASE(3)
    GMT_DEPTH_CASE(4)
    GMT_DEPTH_CASE(5)
    GMT_DEPTH_CASE(6)
    GMT_DEPTH_CASE(7)
#undef GMT_DEPTH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). reads (B, L) int32 with
// L % 3 == 0, lengths (B,) int32, scratch fields (strands, 3, B, L/3) and
// partial (strands, 3, B, M) int32, out (B, M) f32. Launches prep, walk
// and finish on `stream`; returns the first failing cudaError_t, or
// cudaErrorInvalidValue for a depth or table too large for shared memory.
extern "C" int gmt_bank_walk(const void* level_mip, const void* probs_pk,
                             const void* reads, const void* lengths,
                             void* fields, void* partial, void* out, int B,
                             int L, int M, int LR, int R2, int model_len,
                             int depth, int strands, int int8,
                             float inv_scale, void* stream) {
  if (depth < 0 || depth > kMaxDepth || L % 3 != 0 || model_len < 1 ||
      model_len > 16 || strands < 1 || strands > 2 ||
      level_table_rows(depth) > LR || prob_table_rows(depth, int8) > R2 ||
      (level_table_rows(depth) + prob_table_rows(depth, int8)) * kLanes * 4 >
          kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w = model_len - 1;
  const int64_t prep_threads = static_cast<int64_t>(strands) * B * L;
  if (prep_threads > 0) {
    prep_kernel<<<static_cast<unsigned>((prep_threads + 255) / 256), 256, 0,
                  st>>>(static_cast<const int32_t*>(reads),
                        static_cast<const int32_t*>(lengths),
                        static_cast<uint32_t*>(fields), B, L, strands, w);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* lm = static_cast<const int32_t*>(level_mip);
  const auto* pk = static_cast<const int32_t*>(probs_pk);
  const auto* fl = static_cast<const uint32_t*>(fields);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* pa = static_cast<int32_t*>(partial);
  const int rc =
      int8 ? launch_walk_depth<true>(depth, lm, pk, fl, ln, pa, B, L / 3, M,
                                     LR, R2, strands, w, st)
           : launch_walk_depth<false>(depth, lm, pk, fl, ln, pa, B, L / 3, M,
                                      LR, R2, strands, w, st);
  if (rc != 0) return rc;
  const int64_t bm = static_cast<int64_t>(B) * M;
  finish_kernel<<<static_cast<unsigned>((bm + 255) / 256), 256, 0, st>>>(
      pa, static_cast<float*>(out), bm, strands, inv_scale);
  return static_cast<int>(cudaGetLastError());
}
