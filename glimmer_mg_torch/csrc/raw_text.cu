// The raw matrix's DATA rows: a float32 score matrix printed as "%.4f"
// text, on Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package prints the matrix on the host
// (glimmer_mg_tpu/parallel/phymm.py, write_raw_phymm_output), one Python
// "%.4f" call a value; at 16,384 reads x 539 ICMs that loop was most of a
// classified file's time while the card sat idle. Its plain version, which
// this kernel matches byte for byte, is
// glimmer_mg_torch/ops/raw_text_cuda.py::plain_rows.
//
// The text: row g (one a model) holds scores[:, g] as "%.4f", joined by
// single spaces and ended by '\n'. Python's "%.4f" of a float32 x prints
// the exact binary value rounded to 4 decimals, ties to even. For
// |x| < 2^24, x has 24 significant bits and 10^4 = 2^4 * 625 adds 10, so
// (double)|x| * 10^4 is exact in a double's 53 and rint of it (ties to
// even) is the correctly rounded value; it is below 2^24 * 10^4 < 2^38.
// For |x| >= 2^24, x is an integer M * 2^s (M < 2^24, s <= 104), printed
// with ".0000" from base-10^9 limbs. NaN prints "nan" whatever its sign,
// infinities "inf" and "-inf", and every other value with its sign bit
// set, -0.0 and values that round to zero included, has its '-'.
//
// What bounds it: bytes. It reads the matrix, 4 n m bytes, and writes the
// text, about 11 bytes a value of a log-probability (35 MB in, 97 MB out
// at 16,384 x 539: 0.04 ms at 3.35 TB/s). The design:
//  * A value's text is a pure function of its bits, so no pass depends on
//    another's text: measure_kernel sums the widths of each row's tiles
//    of TN reads (loads coalesced along the models), rows_kernel scans
//    the tiles of each row (a warp a row), place_kernel scans the row
//    totals into row offsets and the total; write_kernel then renders the
//    text of each (TM models x TN reads) block at its place.
//  * write_kernel stages the block's scores in shared memory with
//    coalesced loads along the models, and reads them back transposed
//    (a padded row, conflict-free), so that a warp holds 32 consecutive
//    reads of one row. Each lane renders its value into the warp's
//    staging buffer at its scanned offset, and the warp stores the 32
//    values' bytes to device memory as one contiguous run.
//  * Widths are computed twice (measure and write) rather than stored:
//    recomputing costs a few dozen instructions a value, storing them
//    would add n m bytes each way.
// Four launches on the caller's stream, no host sync, no allocation: the
// wrapper passes the tiles' lengths (int32, m x tiles), the row offsets
// (int64, m + 1: the last is the total) and, after reading the total,
// the text buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;        // models (text rows) a block
constexpr int TN = 256;       // reads a block: one tile of each row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PLACE_THREADS = 1024;
// the widest value, FLT_MAX's 39 digits with '-' and ".0000", and its
// separator
constexpr int MAX_SLOT = 46;
constexpr unsigned FULL = 0xffffffffu;

// round(|x| * 10^4), exact for |x| < 2^24 (see the note above)
__device__ __forceinline__ unsigned long long scaled(unsigned u) {
  const double a = static_cast<double>(__uint_as_float(u & 0x7fffffffu));
  return static_cast<unsigned long long>(rint(__dmul_rn(a, 10000.0)));
}

// decimal digits of v
__device__ __forceinline__ int ndigits(unsigned v) {
  return 1 + (v >= 10u) + (v >= 100u) + (v >= 1000u) + (v >= 10000u) +
         (v >= 100000u) + (v >= 1000000u) + (v >= 10000000u) +
         (v >= 100000000u) + (v >= 1000000000u);
}

// |x| >= 2^24 as base-10^9 limbs, the lowest first; returns their count
// (at most 5: FLT_MAX has 39 digits)
__device__ int big_limbs(unsigned u, unsigned* limb) {
  limb[0] = (u & 0x7fffffu) | 0x800000u;
  int n = 1;
  for (int s = static_cast<int>((u >> 23) & 0xffu) - 150; s > 0; s -= 30) {
    const int k = s < 30 ? s : 30;
    unsigned long long carry = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned long long t =
          (static_cast<unsigned long long>(limb[j]) << k) + carry;
      limb[j] = static_cast<unsigned>(t % 1000000000ull);
      carry = t / 1000000000ull;
    }
    for (; carry; carry /= 1000000000ull)
      limb[n++] = static_cast<unsigned>(carry % 1000000000ull);
  }
  return n;
}

// bytes of the "%.4f" text of the float32 with bits u
__device__ int text_width(unsigned u) {
  const unsigned e = (u >> 23) & 0xffu, neg = u >> 31;
  if (e == 0xffu) return (u & 0x7fffffu) ? 3 : 3 + neg;  // nan, [-]inf
  if (e < 151u)
    return neg + ndigits(static_cast<unsigned>(scaled(u) / 10000ull)) + 5;
  unsigned limb[5];
  const int n = big_limbs(u, limb);
  return neg + ndigits(limb[n - 1]) + 9 * (n - 1) + 5;
}

// the w = text_width(u) bytes of the text at dst
__device__ void render(unsigned u, int w, char* dst) {
  const unsigned e = (u >> 23) & 0xffu;
  if (e == 0xffu) {
    const bool nan = (u & 0x7fffffu) != 0;
    dst[w - 3] = nan ? 'n' : 'i';
    dst[w - 2] = nan ? 'a' : 'n';
    dst[w - 1] = nan ? 'n' : 'f';
    if (w == 4) dst[0] = '-';
    return;
  }
  char* p = dst + w;
  if (e < 151u) {
    const unsigned long long q = scaled(u);
    unsigned f = static_cast<unsigned>(q % 10000ull);
    unsigned ip = static_cast<unsigned>(q / 10000ull);
    for (int k = 0; k < 4; ++k, f /= 10u) *--p = static_cast<char>('0' + f % 10u);
    *--p = '.';
    do {
      *--p = static_cast<char>('0' + ip % 10u);
      ip /= 10u;
    } while (ip);
  } else {
    for (int k = 0; k < 4; ++k) *--p = '0';
    *--p = '.';
    unsigned limb[5];
    const int n = big_limbs(u, limb);
    for (int j = 0; j < n - 1; ++j)
      for (int k = 0; k < 9; ++k, limb[j] /= 10u)
        *--p = static_cast<char>('0' + limb[j] % 10u);
    unsigned top = limb[n - 1];
    do {
      *--p = static_cast<char>('0' + top % 10u);
      top /= 10u;
    } while (top);
  }
  if (u >> 31) *--p = '-';
}

__device__ __forceinline__ int warp_inclusive(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// tile_len[g * tiles + t]: the bytes, separators included, of row g's
// reads t * TN .. t * TN + TN - 1. Grid (tiles, models / TM).
__global__ void __launch_bounds__(THREADS)
    measure_kernel(const float* __restrict__ scores, int n, int m, int tiles,
                   int* __restrict__ tile_len) {
  __shared__ int part[WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x, g = blockIdx.y * TM + lane, i0 = t * TN;
  const int reads = min(TN, n - i0);
  int sum = 0;
  if (g < m)
    for (int r = warp; r < reads; r += WARPS)
      sum += text_width(__float_as_uint(
                 scores[static_cast<long long>(i0 + r) * m + g])) + 1;
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && g < m) {
    for (int k = 1; k < WARPS; ++k) sum += part[k][lane];
    tile_len[static_cast<long long>(g) * tiles + t] = sum;
  }
}

// In place, each row's tile lengths become their exclusive sums, and
// row_off[g] gets row g's bytes. A warp a row.
__global__ void __launch_bounds__(THREADS)
    rows_kernel(int* __restrict__ tile_len, int m, int tiles,
                long long* __restrict__ row_off) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= m) return;  // the whole warp
  int* row = tile_len + static_cast<long long>(g) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const int v = t < tiles ? row[t] : 0;
    const int x = warp_inclusive(v, lane);
    if (t < tiles) row[t] = carry + x - v;
    carry += __shfl_sync(FULL, x, 31);
  }
  if (lane == 0) row_off[g] = carry;
}

// In place, the row lengths become the rows' offsets; row_off[m] the
// total. One block.
__global__ void __launch_bounds__(PLACE_THREADS)
    place_kernel(long long* __restrict__ row_off, int m) {
  __shared__ long long wsum[PLACE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int g0 = 0; g0 < m; g0 += PLACE_THREADS) {
    const int g = g0 + threadIdx.x;
    const long long v = g < m ? row_off[g] : 0;
    long long x = v;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = wsum[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const long long y = __shfl_up_sync(FULL, w, d);
        if (lane >= d) w += y;
      }
      wsum[lane] = w;
    }
    __syncthreads();
    if (g < m) row_off[g] = carry + (warp ? wsum[warp - 1] : 0) + x - v;
    carry += wsum[PLACE_THREADS / 32 - 1];
    __syncthreads();  // wsum is read before the next chunk writes it
  }
  if (threadIdx.x == 0) row_off[m] = carry;
}

// The text of models blockIdx.y * TM .. + TM - 1 for reads blockIdx.x * TN
// .. + TN - 1 at row_off[g] + tile_off[g * tiles + t].
__global__ void __launch_bounds__(THREADS)
    write_kernel(const float* __restrict__ scores, int n, int m, int tiles,
                 const int* __restrict__ tile_off,
                 const long long* __restrict__ row_off,
                 char* __restrict__ out) {
  __shared__ unsigned tile[TN][TM + 1];
  __shared__ char stage[WARPS][32 * MAX_SLOT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x, g0 = blockIdx.y * TM, i0 = t * TN;
  const int reads = min(TN, n - i0), models = min(TM, m - g0);
  for (int r = warp; r < reads; r += WARPS)
    if (lane < models)
      tile[r][lane] = __float_as_uint(
          scores[static_cast<long long>(i0 + r) * m + g0 + lane]);
  __syncthreads();
  char* buf = stage[warp];
  for (int c = warp; c < models; c += WARPS) {
    const int g = g0 + c;
    long long at = row_off[g] + tile_off[static_cast<long long>(g) * tiles + t];
    for (int r0 = 0; r0 < reads; r0 += 32) {
      const int r = r0 + lane;
      const bool live = r < reads;
      const unsigned u = live ? tile[r][c] : 0u;
      const int w = live ? text_width(u) : 0;
      const int slot = live ? w + 1 : 0;
      const int x = warp_inclusive(slot, lane);
      const int len = __shfl_sync(FULL, x, 31);
      if (live) {
        render(u, w, buf + x - slot);
        buf[x - 1] = i0 + r == n - 1 ? '\n' : ' ';
      }
      __syncwarp();
      for (int b = lane; b < len; b += 32) out[at + b] = buf[b];
      __syncwarp();  // the run is stored before the next one is rendered
      at += len;
    }
  }
}

}  // namespace

// The first three kernels: tile_len (m x tiles int32) and row_off (m + 1
// int64, the last the text's total bytes). Returns a cudaError_t.
extern "C" int gmt_raw_text_measure(const void* scores, int n, int m,
                                    void* tile_len, void* row_off,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(scores);
  int* len = static_cast<int*>(tile_len);
  long long* off = static_cast<long long*>(row_off);
  const int tiles = (n + TN - 1) / TN;
  const dim3 grid(tiles, (m + TM - 1) / TM);
  const int rows = (m + WARPS - 1) / WARPS;
  measure_kernel<<<grid, THREADS, 0, st>>>(p, n, m, tiles, len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_kernel<<<rows, THREADS, 0, st>>>(len, m, tiles, off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  place_kernel<<<1, PLACE_THREADS, 0, st>>>(off, m);
  return cudaGetLastError();
}

// The text into out (row_off[m] bytes), from what gmt_raw_text_measure
// left in tile_len and row_off. Returns a cudaError_t.
extern "C" int gmt_raw_text_write(const void* scores, int n, int m,
                                  const void* tile_len, const void* row_off,
                                  void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(scores);
  const int* len = static_cast<const int*>(tile_len);
  const long long* off = static_cast<const long long*>(row_off);
  char* o = static_cast<char*>(out);
  const int tiles = (n + TN - 1) / TN;
  const dim3 grid(tiles, (m + TM - 1) / TM);
  write_kernel<<<grid, THREADS, 0, st>>>(p, n, m, tiles, len, off, o);
  return cudaGetLastError();
}

// The constants the wrapper sizes its buffers and checks with.
extern "C" int gmt_raw_text_tile_reads() { return TN; }
extern "C" int gmt_raw_text_max_slot() { return MAX_SLOT; }
