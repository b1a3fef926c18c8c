// Six-frame ICM log-prob walk for per-read glimmer-mg prediction (Hopper).
//
// Replaces the Pallas TPU kernel glimmer_mg_tpu/ops/icm_pallas.py
// _fixed_frame_kernel (launched by fixed_frame_scores_pallas, wrapped by
// mg_six_frame_pallas). Computes exactly the function of the plain PyTorch
// twin glimmer_mg_torch/ops/icm_score.py::mg_six_frame_batch:
//
//   gene[row, 3*v + f, i], ind[row, 3*v + f, i]
//
// the f32 log-prob of position i of sequence variant v (0 = the reversed
// read, 1 = the complemented read) under frame f of the row's gene ICM
// (model_len, depth) and null ICM (model_len 3, depth 2). The walk: node =
// 4*node + base + 1 while mut_info_pos[node] >= max(0, model_len-1-i), for
// at most depth levels; a node with mut_info_pos -2 (pruned) takes its
// parent's probs. Every output is a table read, so the result is bitwise
// equal to the twin, pads included.
//
// Bound on this card. At the prediction path's shapes (B 2,048 x L 768,
// 16 groups of depth-7 ICMs) the kernel writes 75.5 MB and reads ~25 MB of
// tables and reads (0.030 ms at 3.35 TB/s), but makes 18.9 M walks that
// enter ~81 M levels, each level a dependent table read plus 5 integer
// instructions in this SASS (cuobjdump -sass, sm_90a): ~0.55 G integer
// instructions, 0.033 ms over 64 INT32 lanes x 132 SMs x 1.98 GHz. The
// integer issue bounds it, barely above the bytes; chip_smoke.py prints
// the bound from this run's levels. Besides, each gene walk gathers one
// 4-byte prob at a random node from L2 (9.4 M gathers, one 32-byte sector
// each), which neither bound counts.
//
// Design, against that bound:
//   1. Contexts packed once per read. A block owns one read. It loads the
//      read's bases once, coalesced, and keeps both variants in shared
//      memory as 2-bit packed words (16 bases a word, zeros before position
//      0 and at and past the length). A position's window of model_len
//      bases (the (model_len-1)-base context, then the base itself) is one
//      64-bit shift of two adjacent words: the null context (bases i-2,
//      i-1) and the last base are bit fields of it. No thread loads a base
//      or builds a context base by base (the first design spent ~380
//      instructions a position on it).
//   2. The pruned back-up is folded into the prob tables once per bank
//      (ops/icm_cuda.py::fold_pruned_probs, as pack_tables_exact does for
//      the TPU), so a walk ends with one prob read and no mut_info_pos read.
//   3. The group's gene tree down to the walk's depth (mut_info_pos of
//      levels 0..depth-1 of its three frame tables, every node a walk
//      reads) and its whole null ICM (3 x 21 nodes of mut_info_pos and
//      probs) sit in shared memory, staged once per block, each
//      mut_info_pos doubled as int8 (2 * pos is its base's shift in the
//      context, so a level needs no doubling of its own and the byte load
//      sign-extends). A gene walk then reads one value from L2, its prob,
//      against 9 dependent L2 reads of a depth-7 walk before.
//   4. The three gene walks of a position go level-synchronously, unrolled
//      to the depth (a template argument) and branch-free: a stopped walk
//      keeps its node (its mut_info_pos stays below the threshold), so each
//      level issues three independent shared-memory reads and the three
//      final prob reads are independent. The null walks likewise (depth 2).
//      A thread takes two positions at a time, for six independent walks.
//      Positions are the fastest thread index, so the stores coalesce.
// The staging reads the tables in aligned 16-byte chunks. On the H100 this
// ran faster than staging levels 0..5 only (one dependent L2 read left a
// gene walk) and than tiles of 4 or 8 reads of one group a block (less
// staging, fewer blocks), PERF.md.
// Staged sizes: the gene tree 3 x 5,461 B at depth 7 (3 x 1,365 B at 6);
// the null ICM 1,072 B; the packed read 2 x ((L + 16)/16 + 2) words (408 B
// at L 768).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDepth = 7;
constexpr int kPad = 16;          // packed index q = j + kPad: zeros before 0
constexpr int kNullNodes = 21;    // a depth-2 null ICM
constexpr int kNullProbs = 3 * kNullNodes * 4;
constexpr int kNullMipSlots = 64; // 3 x 21 int8, padded
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int tree_nodes(int levels) {
  return ((1 << (2 * levels)) - 1) / 3;
}

// 32-bit words of one packed read variant: window words k and k + 1 with
// k = (i - w + kPad) >> 4 <= (L - 1 + kPad - 2) >> 4 for every i < L
__host__ __device__ inline int packed_words(int L) {
  return (L + kPad) / 16 + 2;
}

size_t smem_bytes(int depth, int L) {
  return sizeof(float) * kNullProbs +
         sizeof(uint32_t) * 2 * static_cast<size_t>(packed_words(L)) +
         sizeof(int8_t) * (kNullMipSlots + 3 * tree_nodes(depth));
}

// dst[j] = 2 * src[j] as int8 for j < n, read in aligned 16-byte chunks.
// A chunk holds whole elements (the table is element-aligned). The wrapper
// checks that the tables start 16-byte aligned, so no chunk starts before
// them, and the allocator rounds allocations up to 512 bytes, so none ends
// past their allocation.
template <typename MipT>
__device__ __forceinline__ void stage_doubled(int8_t* dst,
                                              const MipT* __restrict__ src,
                                              int n) {
  constexpr int kPer = 16 / sizeof(MipT);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int head = static_cast<int>((a & 15u) / sizeof(MipT));
  const int4* chunk = reinterpret_cast<const int4*>(a & ~uintptr_t{15});
  const int chunks = (head + n + kPer - 1) / kPer;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int4 v = __ldg(chunk + c);
    const MipT* e = reinterpret_cast<const MipT*>(&v);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = c * kPer + k - head;
      if (j >= 0 && j < n) dst[j] = static_cast<int8_t>(2 * e[k]);
    }
  }
}

// One block per read (row blockIdx.x): stage, then walk both variants.
template <typename MipT, int kDepth>
__global__ void __launch_bounds__(kThreads)
    six_frame_kernel(const int32_t* __restrict__ reads,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ group,
                     const MipT* __restrict__ gmip,
                     const float* __restrict__ gprobs,
                     const MipT* __restrict__ imip,
                     const float* __restrict__ iprobs,
                     float* __restrict__ gene_out, float* __restrict__ ind_out,
                     int L, int P, int N, int N2, int w) {
  constexpr int kNodes = tree_nodes(kDepth);  // staged nodes per frame
  const int NW = packed_words(L);
  extern __shared__ int4 smem4[];
  float* s_iprob = reinterpret_cast<float*>(smem4);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_iprob + kNullProbs);
  int8_t* s_imip = reinterpret_cast<int8_t*>(s_words + 2 * NW);
  int8_t* s_gmip = s_imip + kNullMipSlots;

  const int row = blockIdx.x;
  const int len = lengths[row];
  const int g = group[row];
  const int64_t gbase = static_cast<int64_t>(g) * P;
  const int64_t ioff = static_cast<int64_t>(g) * 3 * N2;

  // 1. both variants of the read, 2-bit packed: word k of a variant holds
  // packed positions 16k..16k+15 (sequence j = q - kPad) in bits
  // 2(q & 15). Sixteen lanes build one word; the loop bound is the same
  // for the whole block, so every lane takes part in the shuffles.
  const int32_t* read = reads + static_cast<int64_t>(row) * L;
  for (int base = 0; base < NW * 16; base += kThreads) {
    const int q = base + threadIdx.x;
    const int j = q - kPad;
    uint32_t rv = 0u, cv = 0u;
    if (j >= 0 && j < len) {
      rv = static_cast<uint32_t>(read[len - 1 - j]) & 3u;
      cv = static_cast<uint32_t>(read[j] ^ 3) & 3u;  // 3 - b
    }
    rv <<= 2 * (q & 15);
    cv <<= 2 * (q & 15);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      rv |= __shfl_xor_sync(0xffffffffu, rv, off);
      cv |= __shfl_xor_sync(0xffffffffu, cv, off);
    }
    if ((threadIdx.x & 15) == 0 && q < NW * 16) {
      s_words[q >> 4] = rv;
      s_words[NW + (q >> 4)] = cv;
    }
  }

  // 2. the group's tables in shared memory, each mut_info_pos doubled
  // (2 * pos is its base's shift in the context; negatives stay negative)
  // as int8: the gene tree down to the depth, the null ICM
  if constexpr (kNodes > 0) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      stage_doubled(s_gmip + f * kNodes, gmip + (gbase + f % P) * N, kNodes);
    }
  }
  for (int n = threadIdx.x; n < 3 * kNullNodes; n += kThreads) {
    const int f = n / kNullNodes;
    s_imip[n] = static_cast<int8_t>(
        2 * imip[ioff + static_cast<int64_t>(f) * N2 + (n - f * kNullNodes)]);
  }
  for (int n = threadIdx.x; n < kNullProbs; n += kThreads) {
    const int f = n / (kNullNodes * 4);
    s_iprob[n] = iprobs[(ioff + static_cast<int64_t>(f) * N2) * 4 +
                        (n - f * kNullNodes * 4)];
  }
  __syncthreads();

  // 3. the walks of both variants, positions across the threads
  const uint32_t ctx_mask = w >= 16 ? 0xffffffffu : (1u << (2 * w)) - 1u;
  const float* ptab[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) ptab[f] = gprobs + (gbase + f % P) * N * 4;
  for (int v = 0; v < 2; ++v) {
    const uint32_t* words = s_words + v * NW;
    float* gout = gene_out + (static_cast<int64_t>(row) * 6 + 3 * v) * L;
    float* iout = ind_out + (static_cast<int64_t>(row) * 6 + 3 * v) * L;
    // two positions a thread at a time: independent walks to overlap
#pragma unroll 2
    for (int i = threadIdx.x; i < L; i += kThreads) {
      // window position k holds the base at i - w + k, k = 0..w
      const int q0 = i - w + kPad;
      const int k = q0 >> 4;
      const uint64_t x =
          ((static_cast<uint64_t>(words[k + 1]) << 32) | words[k]) >>
          (2 * (q0 & 15));
      const uint32_t ctx = static_cast<uint32_t>(x) & ctx_mask;
      const uint32_t ctx_null =
          static_cast<uint32_t>(x >> (2 * (w - 2))) & 15u;
      const int last = static_cast<int>(x >> (2 * w)) & 3;
      // doubled thresholds: 2 * pos >= 2 * thresh
      const int thresh2 = 2 * max(0, w - i);
      const int thresh2_null = 2 * max(0, 2 - i);

      int node[3] = {0, 0, 0};
#pragma unroll
      for (int lev = 0; lev < kDepth; ++lev) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const int pos2 = s_gmip[f * kNodes + node[f]];
          const int b = static_cast<int>(__funnelshift_r(ctx, 0u, pos2) & 3u);
          node[f] = pos2 >= thresh2 ? 4 * node[f] + b + 1 : node[f];
        }
      }
      int nnode[3] = {0, 0, 0};
#pragma unroll
      for (int lev = 0; lev < 2; ++lev) {
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const int pos2 = s_imip[f * kNullNodes + nnode[f]];
          const int b =
              static_cast<int>(__funnelshift_r(ctx_null, 0u, pos2) & 3u);
          nnode[f] = pos2 >= thresh2_null ? 4 * nnode[f] + b + 1 : nnode[f];
        }
      }
      float gval[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        gval[f] = __ldg(ptab[f] + node[f] * 4 + last);
      }
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        gout[f * L + i] = gval[f];
        iout[f * L + i] = s_iprob[(f * kNullNodes + nnode[f]) * 4 + last];
      }
    }
  }
}

template <typename MipT, int kDepth>
int launch(const int32_t* reads, const int32_t* lengths, const int32_t* group,
           const void* gmip, const float* gprobs, const void* imip,
           const float* iprobs, float* gene_out, float* ind_out, int B, int L,
           int P, int N, int N2, int w, cudaStream_t stream) {
  const size_t smem = smem_bytes(kDepth, L);
  auto* kern = six_frame_kernel<MipT, kDepth>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(B), kThreads, smem, stream>>>(
      reads, lengths, group, static_cast<const MipT*>(gmip), gprobs,
      static_cast<const MipT*>(imip), iprobs, gene_out, ind_out, L, P, N, N2,
      w);
  return static_cast<int>(cudaGetLastError());
}

template <typename MipT>
int launch_depth(int depth, const int32_t* reads, const int32_t* lengths,
                 const int32_t* group, const void* gmip, const float* gprobs,
                 const void* imip, const float* iprobs, float* gene_out,
                 float* ind_out, int B, int L, int P, int N, int N2, int w,
                 cudaStream_t st) {
  switch (depth) {
#define GMT_DEPTH_CASE(d)                                                   \
  case d:                                                                   \
    return launch<MipT, d>(reads, lengths, group, gmip, gprobs, imip,       \
                           iprobs, gene_out, ind_out, B, L, P, N, N2, w, st);
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

// Dynamic shared memory of one block (bytes), for reports.
extern "C" int gmt_six_frame_smem(int depth, int L) {
  return static_cast<int>(smem_bytes(depth, L));
}

// Plain C entry point (bound with ctypes). reads (B, L), lengths (B,) and
// group (B,) int32; gmip (G, P, N) and imip (G, 3, N2) of mip_bytes (2 =
// int16, 4 = int32); gprobs (G, P, N, 4) and iprobs (G, 3, N2, 4) f32 with
// the pruned back-up folded in; outputs (B, 6, L) f32. Returns the first
// failing cudaError_t, or cudaErrorInvalidValue for arguments out of range.
extern "C" int gmt_six_frame(const void* reads, const void* lengths,
                             const void* group, const void* gmip,
                             const void* gprobs, const void* imip,
                             const void* iprobs, void* gene_out,
                             void* ind_out, int B, int L, int P, int N,
                             int N2, int model_len, int depth, int mip_bytes,
                             void* stream) {
  if (depth < 0 || depth > kMaxDepth || model_len < 3 || model_len > 17 ||
      (mip_bytes != 2 && mip_bytes != 4) || P < 1 ||
      N < tree_nodes(depth + 1) || N2 < kNullNodes ||
      smem_bytes(depth, L) > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || L == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const int32_t*>(reads);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* gr = static_cast<const int32_t*>(group);
  const auto* gp = static_cast<const float*>(gprobs);
  const auto* ip = static_cast<const float*>(iprobs);
  auto* go = static_cast<float*>(gene_out);
  auto* io = static_cast<float*>(ind_out);
  const int w = model_len - 1;
  return mip_bytes == 2
             ? launch_depth<int16_t>(depth, r, ln, gr, gmip, gp, imip, ip, go,
                                     io, B, L, P, N, N2, w, st)
             : launch_depth<int32_t>(depth, r, ln, gr, gmip, gp, imip, ip, go,
                                     io, B, L, P, N, N2, w, st);
}
