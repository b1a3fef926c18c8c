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
// (model_len, depth) and null ICM (model_len 3, depth 2). Every output is a
// table read, so the result is bitwise equal to the twin, pads included.
//
// Design. One thread per (row, variant, position). It builds the variant's
// packed 2-bit context once (window position w at bits 2w..2w+1, zeros
// before position 0), then walks the gene tree in 3 frames and the null
// tree in 3 frames: node = 4*node + base + 1 while mut_info_pos[node] >=
// threshold, for at most depth levels, then backs a pruned node
// (mip == -2) up to its parent and reads probs[node*4 + last_base]. The
// read's bank index comes from group[row]. There is no block-to-model map
// and no group-sorted layout: a thread loads its own model's tables.
//
// Bound on this card: latency of the depth (<= 7) dependent global/L2 loads
// of one walk (one 2-byte mip read per level, then one 4-byte prob read).
// The gene tables of a 16-group bank (3 frames x 21,845 nodes x 4 f32 probs
// plus int16 mip, per group) are ~20 MB and stay resident in the 50 MB L2,
// and six independent walks per thread give the scheduler loads to overlap.
// Staging the top levels of mip in shared memory is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename MipT>
__device__ __forceinline__ float walk(const MipT* __restrict__ mip,
                                      const float* __restrict__ probs,
                                      int base_off, int depth, uint32_t ctx,
                                      int thresh, int last) {
  int node = 0;
  for (int k = 0; k < depth; ++k) {
    const int pos = static_cast<int>(__ldg(mip + base_off + node));
    if (pos < thresh) break;
    const int b = static_cast<int>((ctx >> (2 * pos)) & 3u);
    node = 4 * node + b + 1;
  }
  if (static_cast<int>(__ldg(mip + base_off + node)) == -2) {
    node = (node - 1) >> 2;
  }
  return __ldg(probs + static_cast<int64_t>(base_off + node) * 4 + last);
}

// base of variant v at position j (j may be negative: context padding)
__device__ __forceinline__ int variant_base(const int32_t* __restrict__ read,
                                            int len, int v, int j) {
  if (j < 0 || j >= len) return 0;
  return v == 0 ? read[len - 1 - j] : 3 - read[j];
}

template <typename MipT>
__global__ void six_frame_kernel(
    const int32_t* __restrict__ reads, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ group, const MipT* __restrict__ gmip,
    const float* __restrict__ gprobs, const MipT* __restrict__ imip,
    const float* __restrict__ iprobs, float* __restrict__ gene_out,
    float* __restrict__ ind_out, int B, int L, int P, int N, int N2,
    int model_len, int depth) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(B) * 2 * L;
  if (tid >= total) return;
  const int i = static_cast<int>(tid % L);
  const int v = static_cast<int>((tid / L) % 2);
  const int row = static_cast<int>(tid / (2 * static_cast<int64_t>(L)));

  const int32_t* read = reads + static_cast<int64_t>(row) * L;
  const int len = lengths[row];
  const int g = group[row];

  // packed context: window position k holds the base at i - w + k
  const int w = model_len - 1;
  uint32_t ctx = 0;
  for (int k = 0; k < w; ++k) {
    ctx |= static_cast<uint32_t>(variant_base(read, len, v, i - w + k))
           << (2 * k);
  }
  const uint32_t ctx_null =
      static_cast<uint32_t>(variant_base(read, len, v, i - 2)) |
      (static_cast<uint32_t>(variant_base(read, len, v, i - 1)) << 2);
  const int last = variant_base(read, len, v, i);
  const int thresh = max(0, w - i);
  const int thresh_null = max(0, 2 - i);

  const int64_t out_row = static_cast<int64_t>(row) * 6 * L;
  for (int f = 0; f < 3; ++f) {
    const int goff = (g * P + (f % P)) * N;
    const int ioff = (g * 3 + f) * N2;
    const int64_t o = out_row + static_cast<int64_t>(3 * v + f) * L + i;
    gene_out[o] = walk(gmip, gprobs, goff, depth, ctx, thresh, last);
    ind_out[o] = walk(imip, iprobs, ioff, 2, ctx_null, thresh_null, last);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). mip_bytes selects the mip table
// element type (2 = int16, 4 = int32). Returns the launch's cudaError_t.
extern "C" int gmt_six_frame(const void* reads, const void* lengths,
                             const void* group, const void* gmip,
                             const void* gprobs, const void* imip,
                             const void* iprobs, void* gene_out,
                             void* ind_out, int B, int L, int P, int N,
                             int N2, int model_len, int depth, int mip_bytes,
                             void* stream) {
  const int64_t total = static_cast<int64_t>(B) * 2 * L;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* r = static_cast<const int32_t*>(reads);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  const int32_t* gr = static_cast<const int32_t*>(group);
  const float* gp = static_cast<const float*>(gprobs);
  const float* ip = static_cast<const float*>(iprobs);
  float* go = static_cast<float*>(gene_out);
  float* io = static_cast<float*>(ind_out);
  if (mip_bytes == 2) {
    six_frame_kernel<int16_t><<<blocks, threads, 0, s>>>(
        r, ln, gr, static_cast<const int16_t*>(gmip), gp,
        static_cast<const int16_t*>(imip), ip, go, io, B, L, P, N, N2,
        model_len, depth);
  } else if (mip_bytes == 4) {
    six_frame_kernel<int32_t><<<blocks, threads, 0, s>>>(
        r, ln, gr, static_cast<const int32_t*>(gmip), gp,
        static_cast<const int32_t*>(imip), ip, go, io, B, L, P, N, N2,
        model_len, depth);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
