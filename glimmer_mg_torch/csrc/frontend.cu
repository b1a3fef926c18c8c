// KF: the frontend of device prediction -- ORF slots, start scoring and
// event assembly -- of a batch of reads in one launch, on Hopper (sm_90a),
// in the error-free and in the substitution mode.
//
// Replaces glimmer_mg_tpu/ops/device_predict.py:456-1800 (_read_tables
// through _assemble_events) as :2617 _frontend_one runs it inside the JAX
// package's jitted device program (XLA, not Pallas). Its plain PyTorch twin
// is glimmer_mg_torch/ops/frontend.py::frontend; the kernel matches it bit
// for bit on every output: the (B, E) event rows (pos, typ, sub, id, score,
// trunc, and in substitution mode err_pos and err_typ), the padding rows
// past a read's events included, and n_events, which counts every valid
// candidate, also past E.
//
// The mode is a template parameter (SUBS); the substitution mode's state
// (its arrays, slot flags, entries and arguments) lives in types derived
// from the error-free ones and only that instantiation carries it.
// Substitution mode adds, a strand, the sub-extension families: a start
// whose gene runs through its ORF's stop codon, read as a sequencing error
// at the stop penalty, into the next ORF of the frame (std, one a position;
// truncated, 3 forward and 6 reverse); ORFs of frame length >= 15 are kept
// (indel_orfs); each (ORF, error set) gets its own id and stop event; equal
// positions keep the reference's insertion order (tiekey). Its 8 Lp + 33
// candidates are ordered on (pos, tiekey, index), which is the twin's two
// stable argsorts.
//
// What bounds it: not bytes. A 2,048-read chunk at Lp 768 moves about
// 65 MB (the reads, K1's two (B, 6, Lp) f32 tables below each read's
// length, the event rows), 20 microseconds at 3.35 TB/s. A read is a chain
// of block-wide phases over a working set of 35-70 KB, so the kernel is
// held by the latency of each phase's dependent loads, by its barriers and
// by how many reads are in flight on an SM at once.
//
// Design (the Hopper redesign): one block of T = 128 threads a read (a
// grid-stride loop over reads), at least 4 blocks an SM error-free and 3 in
// substitution mode at Lp 768 (__launch_bounds__; the workspace sized to
// fit). Thread t owns a contiguous run of codon columns (positions
// 3c..3c+2), so a frame-class scan (cummax, reverse cummin, cumsum within
// i % 3) is a sequential pass over the thread's columns plus one block scan:
// a warp-shuffle scan (__shfl_up_sync forward, __shfl_down_sync reverse)
// and one pass over the warp totals, one barrier. The six stop/start class
// scans run as one scan of 18 lanes, the class cumsums of the candidate
// indicators as one of 12 (24) lanes, the event-set ids as one lane with
// the end slots' ids read off its total. A read makes 12 block barriers.
// The read's working arrays sit in one workspace of ws_bytes() bytes:
// dynamic shared memory when it fits on the card, else a slice of a global
// scratch buffer the wrapper allocates. Arrays dead after their phase
// share the temp region (class diagonals and RBS window scores; then the
// class cumsums; then the sort keys and the validity bitmap). Below
// NARROW_LP the position scans, ids and class cumsums are int16_t (the
// index type I, a template parameter) and the sort keys 32-bit. Per-read
// values are recomputed where they are read (no per-thread array is
// indexed at run time, so nothing goes to a stack frame); group tables are
// read by group from the bank. The valid candidates are marked in a bitmap
// (one warp ballot a word), compacted in the twin's concatenation order by
// a block scan, and each is written to the row of its rank among the valid
// keys (pos [, tiekey], then its compacted position): the ranks are the
// stable sort's, after one barrier; invalid candidates fill the rows past
// a read's events in concatenation order, as the twin's stable argsort
// puts them. No host sync, no device-side assert, no allocation.
//
// Where bitwise equality is at risk, and what the code does about it:
//  * _blocked_cumsum's order: a sequential inclusive scan inside blocks of
//    16 (the first element taken as it is), the block totals scanned the
//    same way recursively while there are more than 16 (else sequentially),
//    then inner + exclusive total, with +0.0 added in the first block. The
//    levels and their zero padding are those of the twin; no tree scan. A
//    thread scans the three class rows of one 16-block in registers; only
//    the class diagonal R[x] = S[x % 3][x] of each strand's three rows is
//    kept, since every read of the prefix sums is on it.
//  * The class-PWM mixture: the twin sums the masked class products by an
//    explicit left-to-right loop over C and divides by max(nm, 1); the
//    kernel does the same. log is CUDA's log / logf, the function torch's
//    CUDA log calls.
//  * FMA contraction: every float product goes through __dmul_rn /
//    __fmul_rn (mul() below), so nvcc cannot fuse it with an add; division
//    is IEEE. Build without --use_fast_math.
//  * _score_tail's order: (raw + prior), then the RBS boost (score + coeff
//    * pwm, coeff = sep / 4, 1 or (16 - sep) / 6), then the start-codon
//    log-odds, then the length log-odds; the f32 carry converts the bank's
//    f64 and f32 tables and K1's f32 outputs where the twin's .to(fdt)
//    does. Thresholds are rounded to the carry's type before the compare.
//  * clamp(min=0.0) keeps NaN and -0.0 as they are (x < 0 ? 0 : x).
//  * _pwm_window_tables: strict > first maximum (smallest separation wins),
//    then a non-finite best becomes 0.0 for a user PWM and its separation 0.
//  * _dedup: a std start replaces the truncated one at its position only
//    when strictly greater; the truncated entry kills the std entry when
//    the std score is <= its own.
//  * Gathers: every clamp and fill value of _gather_guard, _gather2 and the
//    shifts (0, -inf, BIG, -BIG, -1, false) is spelled out where it is read.
//  * The stop penalty (_stop_penalty): without qualities the four values
//    are the host's doubles (math.log), passed in and rounded to the carry
//    once; with qualities _CP_TAB (passed in) is cast to the carry, the
//    products go in the twin's order through mul(), 2/3 c + 1/3 is a
//    product and a separate add, pp is clamped into [tiny, 1 - eps/2], then
//    log(1 - pp) - log(pp).
//  * The integer scans (max, min, add) are exact in any order, so the warp
//    shuffles may combine them as they do; the int16_t form stores the
//    sentinels +-BIG as INT16_MAX / INT16_MIN and reads them back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Threads a block (one read). Measured on the H100 against 256 (PERF.md
// section 6): at Lp 768, 128 is faster error-free (4 reads an SM against
// 2) and holds 3 reads an SM in substitution mode, where 256 is faster at
// 2; at Lp 2,304 256 is faster in both modes.
constexpr int T = 128;
constexpr int NW = T / 32;  // warps a block (phase 5 takes 4)
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 1 << 29;
constexpr int HALF = BIG / 2;  // BIG // 2
// The narrow index type (int16_t position scans, ids and class cumsums,
// 32-bit sort keys) serves Lp below this: ids stay below 4 (Lp + 3) and
// tie keys below 8 Lp + 44 <= 2^16.
constexpr int NARROW_LP = 8187;
// codon flags of a position; bits 4-5 / 6-7 hold the fwd / rev start codon
// index clamped to 2 (_sel3's clamp), or NONE
constexpr int FS = 1, RS = 2, FT = 4, RT = 8;
constexpr int NONE = 3;
// per-candidate bits of the std families
constexpr uint8_t RAWOK = 1, PASS = 2, FINAL = 4;
constexpr int E_FWD_START = 1, E_FWD_STOP = 2, E_REV_START = 3,
              E_REV_STOP = 4;
// substitution mode: ORFs this long are kept (engine.mg_host
// MIN_INDEL_ORF_LEN), the error type of a substitution record, and the bits
// of a slot's gate byte: evprod, its clean stop event, its sub stop event
constexpr int MIN_INDEL_ORF_LEN = 15, ERR_SUB = 2;
constexpr uint8_t EVP = 1, CLN = 2, SUBB = 4;

struct Args {
  const int* seq;     // (B, Lp)
  const int* n;       // (B,)
  const int* groups;  // (B,)
  const float* gene6;  // (B, 6, Lp)
  const float* ind6;   // (B, 6, Lp)
  const uint8_t* fwd_start;  // (G, 65) bool
  const uint8_t* rev_start;
  const uint8_t* fwd_stop;
  const uint8_t* rev_stop;
  const int* which_fwd;  // (G, 65)
  const int* which_rev;
  const float* prior;      // (G,)
  const float* start_lo;   // (G, NS)
  const double* len_score;  // (G, 3, LN)
  const int* isl;           // (G,)
  const double* pwm_cols;   // (G, C, WT, 4)
  const int* pwm_n;         // (G,)
  const double* pwm_user;   // (G, WT, 4)
  const uint8_t* pwm_is_user;  // (G,)
  const double* gc_lp;         // (G, 4)
  int* o_pos;  // (B, E)
  int* o_typ;
  int* o_sub;
  int* o_id;
  void* o_score;
  uint8_t* o_trunc;
  int* o_nev;  // (B,)
  uint8_t* scratch;  // null: the workspace is in shared memory
  long long ws_bytes;
  int B, Lp, G, NS, LN, C, WT, W, rbw, mgl, E;
  double ev_thresh, start_thresh;
};

// The substitution mode's further arguments.
struct ArgsS : Args {
  const uint8_t* quals;  // (B, Lp) or null: the constant penalties
  const double* cp;      // (256,) _CP_TAB
  int* o_err_pos;        // (B, E)
  int* o_err_typ;
  double pen[4];  // the no-quality penalties, at 2 * mid + last
};

__host__ __device__ inline size_t a16(size_t x) {
  return (x + 15) & ~size_t(15);
}
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int pad16(int x) { return cdiv(x, 16) * 16; }
__host__ __device__ inline size_t maxz(size_t a, size_t b) {
  return a > b ? a : b;
}

// Entries a row of _blocked_cumsum's levels above the first holds: level
// 1 (the block totals of level 0) and each level above it while the level
// below is blocked (> 16 entries), each padded to a multiple of 16.
__host__ __device__ inline int lev_len(int Lp) {
  int m = cdiv(Lp, 16), len = 0;
  for (;;) {
    len += pad16(m);
    if (m <= 16) return len;
    m = cdiv(m, 16);
  }
}

// The workspace layout, in units of U = a16(Lp + 3) bytes: byte arrays
// (codon flags, candidate bits, slot gates), the six class scans and the
// ids (I), the std scores (S; the prefix sums' upper levels before them),
// then the temp region, whose phases alias: (1) the class diagonals R and
// Rr and the RBS window scores pwF and pwR; (2) the class cumsums; (3) the
// sort keys and the validity bitmap.
template <int SZ, int IS, bool SUBS>
struct Lay {
  static constexpr int KS = IS == 2 ? 4 : 8;  // sort key bytes
  static constexpr int FL = 0, CFF = 1, CFR = 2, EVF = 3, EVR = 4,
                       CFSF = 5, CFSR = 6;
  static constexpr int SCAN = SUBS ? 7 : 5;  // psf nsf psr nsr nstf pstr
  static constexpr int ID = SCAN + 6 * IS;   // idF idR [idSF idSR]
  static constexpr int SC = ID + (SUBS ? 4 : 2) * IS;  // scoreF scoreR [SF SR]
  static constexpr int TMP = SC + (SUBS ? 4 : 2) * SZ;
  static constexpr int NF = SUBS ? 8 : 4;  // class cumsums
  __host__ __device__ static int N(int Lp) {
    return SUBS ? 8 * Lp + 33 : 4 * Lp + 18;
  }
  // the temp region's offset (the scores' region holds the upper levels
  // first), the bitmap's offset in it, and the workspace's bytes
  __host__ __device__ static size_t tmp_off(int Lp) {
    const size_t U = a16((size_t)Lp + 3);
    return SC * U + maxz((TMP - SC) * U, a16((size_t)6 * lev_len(Lp) * SZ));
  }
  __host__ __device__ static size_t bits_off(int Lp) {
    return a16((size_t)KS * N(Lp));
  }
  __host__ __device__ static size_t bytes(int Lp) {
    const size_t U = a16((size_t)Lp + 3);
    const size_t ph1 = 4 * SZ * U;
    const size_t ph2 = (size_t)NF * IS * U;
    const size_t ph3 = bits_off(Lp) + a16(4 * (size_t)cdiv(N(Lp), 32));
    return tmp_off(Lp) + maxz(ph1, maxz(ph2, ph3));
  }
};

__host__ __device__ inline size_t ws_bytes(int Lp, int sz, bool subs) {
  const bool nar = Lp < NARROW_LP;
  if (subs) {
    if (sz == 8)
      return nar ? Lay<8, 2, true>::bytes(Lp) : Lay<8, 4, true>::bytes(Lp);
    return nar ? Lay<4, 2, true>::bytes(Lp) : Lay<4, 4, true>::bytes(Lp);
  }
  if (sz == 8)
    return nar ? Lay<8, 2, false>::bytes(Lp) : Lay<8, 4, false>::bytes(Lp);
  return nar ? Lay<4, 2, false>::bytes(Lp) : Lay<4, 4, false>::bytes(Lp);
}

__device__ __forceinline__ int pmod3(int x) {
  const int r = x % 3;
  return r < 0 ? r + 3 : r;
}
__device__ __forceinline__ int fdiv3(int x) {
  return x >= 0 ? x / 3 : -((2 - x) / 3);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int topj(int mm) {
  const int t = fdiv3(mm - 1) * 3;
  return t < -3 ? -3 : t;
}
__device__ __forceinline__ int vstop(int c) {
  return c == 0 ? -1 : (c == 1 ? 0 : -2);
}
template <typename V>
__device__ __forceinline__ V sel3(int i, V a, V b, V c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
template <typename S>
__device__ __forceinline__ S clamp0(S x) {
  return x < (S)0 ? (S)0 : x;
}
template <typename S>
__device__ __forceinline__ S neg_inf() {
  return -(S)INFINITY;
}

// An index array of the workspace: int16_t stores the sentinels +-BIG as
// INT16_MAX / INT16_MIN.
__device__ __forceinline__ int dec(int16_t v) {
  return v == INT16_MIN ? -BIG : (v == INT16_MAX ? BIG : (int)v);
}
__device__ __forceinline__ int dec(int v) { return v; }
__device__ __forceinline__ void enc(int16_t* p, int v) {
  *p = (int16_t)(v <= -HALF ? INT16_MIN : (v >= HALF ? INT16_MAX : v));
}
__device__ __forceinline__ void enc(int* p, int v) { *p = v; }

template <typename I>
struct Ix {
  I* p;
  __device__ __forceinline__ int operator[](int i) const { return dec(p[i]); }
  __device__ __forceinline__ void set(int i, int v) const { enc(p + i, v); }
};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Block scans of NL integer lanes, in two halves around one barrier.
// scan_warp: each warp's inclusive scan (lanes in thread order, or with
// REV in reverse thread order); lane 31 (REV: 0) puts the warp's totals in
// wbuf[l * NW + warp]. Then, after a __syncthreads(), scan_block: v gets op
// over the threads before this one (REV: after it), or id; tot op over all
// threads. A block keeps a barrier between two uses of one wbuf.
template <bool REV, int NL, class Op>
__device__ __forceinline__ void scan_warp(int (&v)[NL], Op op, int* wbuf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int y = REV ? __shfl_down_sync(FULL, v[l], d)
                        : __shfl_up_sync(FULL, v[l], d);
      if (REV ? lane + d < 32 : lane >= d) v[l] = op(v[l], y);
    }
  if (lane == (REV ? 0 : 31))
#pragma unroll
    for (int l = 0; l < NL; ++l) wbuf[l * NW + w] = v[l];
}

template <bool REV, int NL, class Op>
__device__ __forceinline__ void scan_block(int (&v)[NL], int (&tot)[NL],
                                           Op op, int id, const int* wbuf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int y = REV ? __shfl_down_sync(FULL, v[l], 1)
                      : __shfl_up_sync(FULL, v[l], 1);
    int p = id, t = id;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int x = wbuf[l * NW + k];
      if (REV ? k > w : k < w) p = op(p, x);
      t = op(t, x);
    }
    tot[l] = t;
    v[l] = lane == (REV ? 31 : 0) ? p : op(p, y);
  }
}

// The thread's codon columns [c0, c1) of ncol.
__device__ __forceinline__ void my_cols(int ncol, int& c0, int& c1) {
  const int K = cdiv(ncol, T);
  c0 = min((int)threadIdx.x * K, ncol);
  c1 = min(c0 + K, ncol);
}

// One read's state: the workspace (arrays at Lay's offsets, computed where
// they are read) and the group's tables.
template <typename S, typename I, bool SUBS>
struct Rd {
  using L = Lay<(int)sizeof(S), (int)sizeof(I), SUBS>;
  unsigned char* ws;
  size_t U, tmp;  // the unit, the temp region's offset
  int Lp, n, mgl, min_j, isl, LN, nm, W, rbw;
  bool is_user, any_mode;
  S prior, ev, th;
  const double* len;   // (3, LN)
  const float* slo;    // (NS,)

  __device__ __forceinline__ uint8_t* b8(int k) const { return ws + k * U; }
  __device__ __forceinline__ Ix<I> ix(int k) const {
    return {(I*)(ws + k * U)};
  }
  __device__ __forceinline__ S* sv(int k) const { return (S*)(ws + k * U); }
  __device__ __forceinline__ uint8_t* fl() const { return b8(L::FL); }
  __device__ __forceinline__ uint8_t* cfF() const { return b8(L::CFF); }
  __device__ __forceinline__ uint8_t* cfR() const { return b8(L::CFR); }
  __device__ __forceinline__ uint8_t* evF() const { return b8(L::EVF); }
  __device__ __forceinline__ uint8_t* evR() const { return b8(L::EVR); }
  __device__ __forceinline__ Ix<I> psf() const { return ix(L::SCAN); }
  __device__ __forceinline__ Ix<I> nsf() const {
    return ix(L::SCAN + (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> psr() const {
    return ix(L::SCAN + 2 * (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> nsr() const {
    return ix(L::SCAN + 3 * (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> nstf() const {
    return ix(L::SCAN + 4 * (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> pstr() const {
    return ix(L::SCAN + 5 * (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> idF() const { return ix(L::ID); }
  __device__ __forceinline__ Ix<I> idR() const {
    return ix(L::ID + (int)sizeof(I));
  }
  __device__ __forceinline__ S* scoreF() const { return sv(L::SC); }
  __device__ __forceinline__ S* scoreR() const {
    return sv(L::SC + (int)sizeof(S));
  }
  // the prefix sums' upper levels (phases 1-3, before the scores)
  __device__ __forceinline__ S* lev() const { return sv(L::SC); }
  // temp region, phase 1: class diagonals, RBS windows
  __device__ __forceinline__ S* tv(int k) const {
    return (S*)(ws + tmp + k * sizeof(S) * U);
  }
  __device__ __forceinline__ S* R() const { return tv(0); }
  __device__ __forceinline__ S* Rr() const { return tv(1); }
  __device__ __forceinline__ S* pwF() const { return tv(2); }
  __device__ __forceinline__ S* pwR() const { return tv(3); }
  // phase 2: the class cumsums F(k) (k < L::NF); phase 3: keys, bitmap
  __device__ __forceinline__ Ix<I> F(int k) const {
    return {(I*)(ws + tmp + k * sizeof(I) * U)};
  }
  __device__ __forceinline__ void* keys() const { return ws + tmp; }
  __device__ __forceinline__ unsigned* bits() const {
    return (unsigned*)(ws + tmp + L::bits_off(Lp));
  }
  // the substitution mode's arrays
  __device__ __forceinline__ uint8_t* cfSF() const { return b8(L::CFSF); }
  __device__ __forceinline__ uint8_t* cfSR() const { return b8(L::CFSR); }
  __device__ __forceinline__ Ix<I> idSF() const {
    return ix(L::ID + 2 * (int)sizeof(I));
  }
  __device__ __forceinline__ Ix<I> idSR() const {
    return ix(L::ID + 3 * (int)sizeof(I));
  }
  __device__ __forceinline__ S* scoreSF() const {
    return sv(L::SC + 2 * (int)sizeof(S));
  }
  __device__ __forceinline__ S* scoreSR() const {
    return sv(L::SC + 3 * (int)sizeof(S));
  }
};

// The substitution mode's further state of a read.
template <typename S, typename I>
struct RdS : Rd<S, I, true> {
  const int* seq;        // (Lp,) the read
  const uint8_t* q;      // (Lp,) its qualities, or null
  const double* cp;      // _CP_TAB
  const S* pen;          // (4,) the no-quality penalties in the carry's type
  S two3, one3;
  int lowest_j;
};

// fwd_prev: the Save_Prev_Stops register (max of the class's initial value
// and the previous fwd stop).
template <class R>
__device__ __forceinline__ int fwd_prev(const R& r, int x) {
  const int c = x % 3;
  const int init = c == 0 ? 0 : (c == 1 ? 1 : -1);
  const int p = r.psf()[x];
  return init > p ? init : p;
}

template <class R>
__device__ __forceinline__ int rev_next(const R& r, int x) {
  const int fr = pmod3(r.n - 1 - x);
  const int init = fr == 0 ? r.n - 1 : (fr == 1 ? r.n - 2 : r.n);
  const int nx = x + 2 < r.Lp ? r.nsr()[x + 2] : BIG;
  const int cand = nx < BIG ? nx - 2 : BIG;
  return init < cand ? init : cand;
}

// the first fwd start of class k past the read's first codon (npc) and the
// rev ORF end of class c before any rev stop (rnc)
template <class R>
__device__ __forceinline__ int npc(const R& r, int k) {
  return r.nstf()[sel3(k, 3, 4, 2)];
}
template <class R>
__device__ __forceinline__ int rnc(const R& r, int c) {
  return rev_next(r, sel3(c, 1, 2, 0));
}

// first fwd start after the previous stop, read at position i (ssp)
template <class R>
__device__ __forceinline__ int ssp(const R& r, int i) {
  const int p = r.psf()[i];
  if (p <= -HALF) return BIG;
  return p + 3 < r.Lp ? r.nstf()[p + 3] : BIG;
}

// rev_next[prev rev stop + 1], read at position i (ffn)
template <class R>
__device__ __forceinline__ int ffn(const R& r, int i) {
  const int p = r.psr()[i];
  if (p <= -HALF) return 0;
  return p + 1 < r.Lp ? rev_next(r, p + 1) : 0;
}

struct Slot {
  int iS, lo, hi, mm, top;
  bool emit, trunc, t3;
};

// Forward-ORF slot s in [0, Lp + 3) (_fwd_orf_slots, indel_orfs=SUBS).
template <bool SUBS, class R>
__device__ __forceinline__ Slot fwd_slot(const R& r, int s) {
  const int Lp = r.Lp, n = r.n;
  Slot o;
  int ip, ssprev, ssnp;
  bool exists;
  if (s < Lp) {
    o.iS = s;
    ip = s >= 3 ? r.psf()[s - 3] : -BIG;
    ssprev = s >= 3 ? ssp(r, s - 3) : BIG;
    ssnp = npc(r, s % 3);
    exists = r.fl()[s] & FT;
    o.lo = (s >= 3 ? fwd_prev(r, s - 3) : s - 3) + 1;
    o.t3 = s >= n;
  } else {
    const int k = s - Lp;
    o.iS = n + k;
    const int cv = pmod3(n + k);
    ip = r.psf()[Lp - 3 + cv];
    ssprev = ssp(r, Lp - 3 + cv);
    ssnp = npc(r, cv);
    exists = true;
    const int xv = n + k - 3;
    const int fpv = (xv >= 0 && xv < Lp) ? fwd_prev(r, xv) : 0;
    o.lo = ((xv >= 0 && xv < n) ? fpv : xv) + 1;
    o.t3 = true;
  }
  const bool hp = ip > -HALF;
  const int sstar = hp ? ssprev : ssnp;
  int gl = sstar < o.iS ? o.iS - sstar : 0;
  const int ol = hp ? o.iS - ip - 3 : (o.iS - 2) - pmod3(o.iS - 2);
  if (!hp && gl < r.mgl) gl = ol;
  o.emit = exists && (gl >= r.mgl || (SUBS && ol >= MIN_INDEL_ORF_LEN));
  o.hi = o.iS - 2;
  o.mm = o.hi - o.lo;
  o.top = topj(o.mm);
  o.trunc = o.lo < 3;
  return o;
}

// Reverse-ORF slot s in [0, Lp + 3) (_rev_orf_slots, indel_orfs=SUBS).
template <bool SUBS, class R>
__device__ __forceinline__ Slot rev_slot(const R& r, int s) {
  const int Lp = r.Lp, n = r.n;
  Slot o;
  int c, ip, ls, ffv;
  bool exists, virt = s >= Lp;
  if (!virt) {
    c = s % 3;
    ip = s >= 3 ? r.psr()[s - 3] : -BIG;
    ls = s >= 3 ? r.pstr()[s - 3] : -BIG;
    exists = r.fl()[s] & RT;
    ffv = s >= 3 ? ffn(r, s - 3) : 0;
  } else {
    c = s - Lp;
    ip = r.psr()[Lp - 3 + c];
    ls = (n - 3 >= 0 && n - 3 < Lp) ? r.pstr()[n - 3] : -BIG;
    exists = true;
    ffv = ffn(r, Lp - 3 + c);
  }
  const bool hp = ip > -HALF;
  const int orf_stop = hp ? ip - 1 : vstop(c);
  const bool ls_ok = ls > (hp ? ip : -BIG) && ls > -HALF;
  int gl = ls_ok ? (ls - 1) - orf_stop : 0;
  bool indel_keep = false;
  if (virt) {
    int eol = n - orf_stop - 2;
    eol -= pmod3(eol);
    if (gl < r.mgl) gl = eol;
    if (SUBS) indel_keep = eol >= MIN_INDEL_ORF_LEN;
  } else if (SUBS) {
    indel_keep = s - orf_stop - 4 >= MIN_INDEL_ORF_LEN;
  }
  o.emit = exists && (gl >= r.mgl || indel_keep);
  const int x_ep = orf_stop + 2;
  const int rnv = hp ? ffv : rnc(r, c);
  o.hi = ((x_ep >= 0 && x_ep < n) ? rnv : x_ep) + 1;
  o.lo = orf_stop + 3;
  o.mm = o.hi - o.lo;
  o.top = topj(o.mm);
  o.trunc = (n - (o.hi - 1)) < 3;
  o.t3 = orf_stop < 1;
  return o;
}

// the closing slot of a member (prop's revfill, else the virtual tail)
template <class R>
__device__ __forceinline__ int slot_mf(const R& r, int q) {
  const int nx = q + 5 < r.Lp ? r.nsf()[q + 5] : BIG;
  return nx < BIG ? nx : r.Lp + pmod3(q + 2 - r.n);
}
template <class R>
__device__ __forceinline__ int slot_mr(const R& r, int u) {
  const int nx = u + 3 < r.Lp ? r.nsr()[u + 3] : BIG;
  return nx < HALF ? nx : r.Lp + u % 3;
}

// ---- substitution mode: the next / previous slot reads ----

// The forward slot after position x in its frame (nxt's slot): the next
// stop of x's class past x, else the virtual slot of x's class.
template <class R>
__device__ __forceinline__ int next_f(const R& r, int x) {
  const int nx = x + 3 < r.Lp ? r.nsf()[x + 3] : BIG;
  return nx < BIG ? nx : r.Lp + pmod3(x - r.n);
}
// mm2: the suffix length at a forward stop x (to the next slot's stop).
template <class R>
__device__ __forceinline__ int mm2_f(const R& r, int x) {
  const int nx = x + 3 < r.Lp ? r.nsf()[x + 3] : BIG;
  return (nx < BIG ? nx : r.n + pmod3(x - r.n)) - x - 3;
}
// A_ext at a forward slot: the class diagonal at hi(s) - 1.
template <typename S, class R>
__device__ __forceinline__ S a_slot(const R& r, int s) {
  if (s < r.Lp) return s >= 3 ? r.R()[s - 3] : (S)0;
  const int xv = r.n + (s - r.Lp) - 3;
  return (xv >= 0 && xv < r.Lp) ? r.R()[xv] : (S)0;
}
// The previous forward stop of slot s (the ORF's ip), or -BIG.
template <class R>
__device__ __forceinline__ int prev_f(const R& r, int s) {
  if (s < r.Lp) return s >= 3 ? r.psf()[s - 3] : -BIG;
  return r.psf()[r.Lp - 3 + pmod3(r.n + s - r.Lp)];
}
// The tie key of a slot's events (4 x the slot's rank key of _assign_ids).
__device__ __forceinline__ int k4_f(int Lp, int s) {
  return 4 * (s < Lp ? 2 * s + 1 : 2 * Lp + 8 + (s - Lp));
}
__device__ __forceinline__ int k4_r(int Lp, int s) {
  return 4 * (s < Lp ? 2 * s : 2 * Lp + 4 + (s - Lp));
}

__device__ __forceinline__ double pp_lo(double) { return 0x1p-1022; }
__device__ __forceinline__ float pp_lo(float) { return 0x1p-126f; }
__device__ __forceinline__ double pp_hi(double) { return 1.0 - 0x1p-53; }
__device__ __forceinline__ float pp_hi(float) { return 1.0f - 0x1p-24f; }

// Pass_Stop_Penalty of a stop codon read through as a substitution, whose
// last base (in the read) is x (_stop_penalty). mid / last: the codon's
// middle / last base in the gene's direction is the one the reference
// weighs up.
template <typename S, typename I>
__device__ __forceinline__ S stop_pen(const RdS<S, I>& r, int x, bool mid,
                                      bool last, bool fwd) {
  if (!r.q) return r.pen[2 * mid + last];
  auto cp = [&](int y) { return (S)r.cp[r.q[y]]; };
  const S c = cp(x);
  const S c1 = x >= 1 ? cp(x - 1) : (S)0.5;
  const S c0 = x >= 2 ? cp(x - 2) : (S)0.5;
  auto fa = [&](bool is, S v) { return is ? mul(r.two3, v) + r.one3 : v; };
  S pp = fwd ? mul(mul(c0, fa(mid, c1)), fa(last, c))
             : mul(mul(c, fa(mid, c1)), fa(last, c0));
  const S lo = pp_lo(pp), hi = pp_hi(pp);
  pp = pp < lo ? lo : (pp > hi ? hi : pp);
  return lg((S)1 - pp) - lg(pp);
}

// suf_pos at a forward stop x: the penalty plus the next slot's segment.
template <typename S, typename I>
__device__ __forceinline__ S suf_f(const RdS<S, I>& r, int x) {
  const bool mid = x >= 1 && r.seq[x - 1] == 0, last = r.seq[x] == 0;
  return stop_pen(r, x, mid, last, true) +
         (a_slot<S>(r, next_f(r, x)) - r.R()[x]);
}
// suf_pos at a reverse stop x: the penalty plus the segment of the ORF it
// closes.
template <typename S, typename I>
__device__ __forceinline__ S suf_r(const RdS<S, I>& r, int x) {
  const S* Rr = r.Rr();
  const S a = x >= 3 ? Rr[x - 3] : (S)0;
  S b = (S)0;
  if (x >= 3) {
    const int y = x - 3, p = r.psr()[y], c = y % 3;
    b = p > -HALF ? Rr[p] : (c == 0 ? Rr[0] : (c == 1 ? Rr[1] : (S)0));
  }
  const bool mid = x >= 1 && r.seq[x - 1] == 3;
  const bool last = x >= 2 && r.seq[x - 2] == 3;
  return stop_pen(r, x, mid, last, false) + (a - b);
}

// Best RBS window of a start at 0-based p (_pwm_window_tables + fix).
template <typename S, class R>
__device__ __forceinline__ void best_f(const R& r, int p, S& best, int& sep) {
  best = neg_inf<S>();
  sep = 0;
  if (r.any_mode) {
    const S* pw = r.pwF();
    for (int s = 0; s <= r.rbw - r.W; ++s)
      if (p - r.W - s >= 0) {
        const S v = pw[p - r.W - s];
        if (v > best) {
          best = v;
          sep = s;
        }
      }
  }
  if (!isfinite(best)) {
    if (r.is_user) best = (S)0;
    sep = 0;
  }
}
template <typename S, class R>
__device__ __forceinline__ void best_r(const R& r, int p, S& best, int& sep) {
  best = neg_inf<S>();
  sep = 0;
  if (r.any_mode) {
    const S* pw = r.pwR();
    for (int s = 0; s <= r.rbw - r.W; ++s)
      if (p + r.W + s < r.n) {
        const S v = p + s + 1 < r.Lp ? pw[p + s + 1] : neg_inf<S>();
        if (v > best) {
          best = v;
          sep = s;
        }
      }
  }
  if (!isfinite(best)) {
    if (r.is_user) best = (S)0;
    sep = 0;
  }
}

// Add_Events' separation-weighted RBS boost (_add_pwm).
template <typename S>
__device__ __forceinline__ S add_pwm(S score, S pwm, int sep) {
  S coeff;
  if (sep < 4)
    coeff = (S)sep / (S)4;
  else if (sep <= 10)
    coeff = (S)1;
  else if (sep < 16)
    coeff = (S)(16 - sep) / (S)6;
  else
    coeff = (S)0;
  return (pwm >= (S)0 && coeff > (S)0) ? score + mul(coeff, pwm) : score;
}

// prior + RBS boost + start-codon log-odds + length log-odds (_score_tail).
template <typename S, bool RBS, class R>
__device__ __forceinline__ S score_tail(const R& r, S raw, S pwm, int sep,
                                        int row, int idx, int wcode) {
  S s = raw + r.prior;
  if (RBS) s = add_pwm(s, pwm, sep);
  if (wcode != NONE) s = s + (S)r.slo[wcode];
  return s + (S)r.len[row * r.LN + idx];
}

// A candidate of the concatenation (the event row it would make).
template <typename S>
struct Item {
  int pos, typ, sub, id;
  S score;
  bool trunc, valid;
};

template <typename S>
struct Tr {  // the 6 + 6 truncated-start entries, in shared memory
  int slot[12], slotc[12], q[12], pos[12], sub[12];
  uint8_t fin[12], raw[12], kill[12];  // tr_final, tr_valid & raw > th
  S score[12];
};

// The substitution mode's truncated sub entries: 0-2 extend the forward
// entries 0-2 (a class chain's first ORF), 3-8 the reverse entries 6-11.
// s2 is the slot whose ORF a sub entry extends, ok its s2slot6_valid.
template <typename S>
struct TrS : Tr<S> {
  int s2[9], epos[9];
  uint8_t ok[9], sfin[9], sraw[9], skill[9];
  S sscore[9];
};

template <typename S, class R>
__device__ __forceinline__ Item<S> item(const R& r, const Tr<S>& tr,
                                        int idx) {
  const int Lp = r.Lp;
  Item<S> it;
  it.trunc = false;
  it.score = (S)0;
  if (idx < Lp) {  // std_f
    const int q = idx, sl = slot_mf(r, q);
    it.valid = (r.cfF()[q] & FINAL) && r.evF()[sl];
    it.pos = q + 3;
    it.typ = E_FWD_START;
    it.sub = q % 3;
    it.id = r.idF()[sl];
    it.score = r.scoreF()[q];
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_f
    it.valid = tr.fin[idx] && r.evF()[tr.slotc[idx]];
    it.pos = tr.pos[idx];
    it.typ = E_FWD_START;
    it.sub = tr.sub[idx];
    it.id = r.idF()[tr.slotc[idx]];
    it.score = tr.score[idx];
    it.trunc = true;
    return it;
  }
  idx -= 6;
  if (idx < Lp + 3) {  // stop_f
    const int s = idx, iS = s < Lp ? s : r.n + s - Lp;
    it.valid = r.evF()[s];
    it.pos = iS + 1;
    it.typ = E_FWD_STOP;
    it.sub = (pmod3(iS) + 1) % 3;
    it.id = r.idF()[s];
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp) {  // std_r
    const int u = idx, sl = slot_mr(r, u);
    it.valid = (r.cfR()[u] & FINAL) && r.evR()[sl];
    it.pos = u + 1;
    it.typ = E_REV_START;
    it.sub = 3 + (u % 3 + 1) % 3;
    it.id = r.idR()[sl];
    it.score = r.scoreR()[u];
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_r
    const int k = 6 + idx;
    it.valid = tr.fin[k] && r.evR()[tr.slotc[k]];
    it.pos = tr.pos[k];
    it.typ = E_REV_START;
    it.sub = tr.sub[k];
    it.id = r.idR()[tr.slotc[k]];
    it.score = tr.score[k];
    it.trunc = true;
    return it;
  }
  idx -= 6;  // stop_r
  const int s = idx;
  int ip, c;
  if (s < Lp) {
    c = s % 3;
    ip = s >= 3 ? r.psr()[s - 3] : -BIG;
  } else {
    c = s - Lp;
    ip = r.psr()[Lp - 3 + c];
  }
  const int orf_stop = ip > -HALF ? ip - 1 : vstop(c);
  it.valid = r.evR()[s];
  it.pos = orf_stop + 2;
  it.typ = E_REV_STOP;
  it.sub = 3 + (c + 1) % 3;
  it.id = r.idR()[s];
  return it;
}

// A candidate of the substitution mode's concatenation, with its error
// record and tie key.
template <typename S>
struct ItemS : Item<S> {
  int err_pos, err_typ, tk;
};

// Candidate idx of the substitution mode's concatenation: std_f, tr_f,
// sub_std_f, sub_tr_f, stop_f, sub_stop_f, sub_std_r, sub_tr_r, std_r,
// tr_r, stop_r, sub_stop_r. The clean starts are item()'s (a slot's gate
// byte is nonzero exactly when evprod is set); the clean stops are gated on
// CLN, the sub stops on SUBB. Forward ties go starts (phase 1) then stops
// (clean 2, sub 3); reverse stops (clean 0, sub 1) then starts (2).
template <typename S, typename I>
__device__ __forceinline__ ItemS<S> item_s(const RdS<S, I>& r,
                                           const TrS<S>& tr, int idx) {
  const int Lp = r.Lp;
  const int EF = 2 * Lp + 9;  // item()'s offset of the reverse families
  ItemS<S> it;
  it.err_pos = -1;
  it.err_typ = -1;
  auto clean = [&](int i, int tk) {
    static_cast<Item<S>&>(it) = item(r, tr, i);
    it.tk = tk;
  };
  // a sub stop: the clean stop event i of item()'s order with its own
  // gate, id and error record
  auto sub_stop = [&](int i, int tk, bool valid, int id, int err_pos) {
    clean(i, tk);
    it.valid = valid;
    it.id = id;
    it.err_pos = err_pos;
    it.err_typ = ERR_SUB;
  };
  auto sub_ev = [&](int pos, int typ, int sub, int id, S score, bool trunc,
                    bool valid, int err_pos, int tk) {
    it.pos = pos;
    it.typ = typ;
    it.sub = sub;
    it.id = id;
    it.score = score;
    it.trunc = trunc;
    it.valid = valid;
    it.err_pos = err_pos;
    it.err_typ = ERR_SUB;
    it.tk = tk;
  };
  if (idx < Lp) {  // std_f
    clean(idx, k4_f(Lp, slot_mf(r, idx)) + 1);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_f
    clean(Lp + idx, k4_f(Lp, tr.slotc[idx]) + 1);
    return it;
  }
  idx -= 6;
  if (idx < Lp) {  // sub_std_f: ids and gates of the slot after the stop
    const int q = idx;
    const int s1 = q + 5 < Lp ? r.nsf()[q + 5] : BIG;
    const bool has = s1 < BIG;
    const int s2 = has ? next_f(r, s1) : 0;
    const int ivirt = r.n + pmod3(q + 2 - r.n);
    sub_ev(q + 3, E_FWD_START, q % 3, has ? r.idSF()[s2] : 0,
           r.scoreSF()[q], false,
           (r.cfSF()[q] & FINAL) && has && (r.evF()[s2] & EVP),
           (s1 < ivirt ? s1 : ivirt) - 1, (has ? k4_f(Lp, s2) : 0) + 1);
    return it;
  }
  idx -= Lp;
  if (idx < 3) {  // sub_tr_f
    const int s2 = tr.s2[idx];
    sub_ev(tr.pos[idx], E_FWD_START, tr.sub[idx], r.idSF()[s2],
           tr.sscore[idx], true,
           tr.sfin[idx] && tr.ok[idx] && (r.evF()[s2] & EVP), tr.epos[idx],
           k4_f(Lp, s2) + 1);
    return it;
  }
  idx -= 3;
  if (idx < Lp + 3) {  // stop_f
    clean(Lp + 6 + idx, k4_f(Lp, idx) + 2);
    it.valid = (r.evF()[idx] & CLN) != 0;
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp + 3) {  // sub_stop_f: the error is at the ORF's previous stop
    const int s = idx, ip = prev_f(r, s);
    sub_stop(Lp + 6 + s, k4_f(Lp, s) + 3, (r.evF()[s] & SUBB) != 0,
             r.idSF()[s], (ip > -HALF ? ip : 0) - 1);
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp) {  // sub_std_r: ids and gates of the ORF before u's
    const int u = idx, p = r.psr()[u];
    const bool hp = p > -HALF;
    sub_ev(u + 1, E_REV_START, 3 + (u % 3 + 1) % 3, hp ? r.idSR()[p] : 0,
           r.scoreSR()[u], false,
           (r.cfSR()[u] & FINAL) && hp && (r.evR()[p] & EVP), p + 1,
           (hp ? k4_r(Lp, p) : 0) + 2);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // sub_tr_r
    const int e = 3 + idx, s2 = tr.s2[e];
    sub_ev(tr.pos[6 + idx], E_REV_START, tr.sub[6 + idx], r.idSR()[s2],
           tr.sscore[e], true, tr.sfin[e] && tr.ok[e] && (r.evR()[s2] & EVP),
           tr.epos[e], k4_r(Lp, s2) + 2);
    return it;
  }
  idx -= 6;
  if (idx < Lp) {  // std_r
    clean(EF + idx, k4_r(Lp, slot_mr(r, idx)) + 2);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_r
    clean(EF + Lp + idx, k4_r(Lp, tr.slotc[6 + idx]) + 2);
    return it;
  }
  idx -= 6;
  if (idx < Lp + 3) {  // stop_r
    clean(EF + Lp + 6 + idx, k4_r(Lp, idx));
    it.valid = (r.evR()[idx] & CLN) != 0;
    return it;
  }
  idx -= Lp + 3;  // sub_stop_r: the error is at the closing stop
  sub_stop(EF + Lp + 6 + idx, k4_r(Lp, idx) + 1, (r.evR()[idx] & SUBB) != 0,
           r.idSR()[idx], idx + 1);
  return it;
}

// The sort key of a valid candidate: its position, then (substitution
// mode) its tie key; 32-bit with the narrow index type (pos in int16_t's
// range, tiekey < 2^16), else 64-bit. Equal keys keep their compacted
// (concatenation) order.
__device__ __forceinline__ void put_key(void* keys, int k, int pos, int tk,
                                        int16_t) {
  ((uint32_t*)keys)[k] = ((uint32_t)(pos + 32768) << 16) | (uint32_t)tk;
}
__device__ __forceinline__ void put_key(void* keys, int k, int pos, int tk,
                                        int) {
  ((unsigned long long*)keys)[k] =
      ((unsigned long long)((uint32_t)pos ^ 0x80000000u) << 32) |
      (uint32_t)tk;
}
// Rank of the key at compacted position k among the nv keys: the keys
// below it, and the equal ones before it.
template <typename K>
__device__ __forceinline__ int key_rank(const void* keys, int k, int nv) {
  const K* ks = (const K*)keys;
  const K me = ks[k];
  int rank = 0;
  for (int j = 0; j < nv; ++j) {
    const K x = ks[j];
    rank += (x < me) | ((x == me) & (j < k));
  }
  return rank;
}

// A forward seg_exists at slot x: some candidate of the ORF's run in F.
template <class R, class F>
__device__ __forceinline__ bool seg_f(const R& r, F f, int x) {
  const int Lp = r.Lp;
  auto fh = [&](int y) { return y >= 5 ? f[y - 5] : 0; };
  auto ffz = [&](int y) {
    const int p = r.psf()[y];
    return p > -HALF ? fh(p) : 0;
  };
  if (x < Lp) return fh(x) - (x >= 3 ? ffz(x - 3) : 0) > 0;
  const int k = x - Lp;
  return f[Lp - 3 + pmod3(r.n + k + 1)] - ffz(Lp - 3 + pmod3(r.n + k)) > 0;
}
template <class R, class F>
__device__ __forceinline__ bool seg_r(const R& r, F f, int x) {
  const int Lp = r.Lp;
  auto fh = [&](int y) { return y >= 3 ? f[y - 3] : 0; };
  auto ffz = [&](int y) {
    const int p = r.psr()[y];
    return p > -HALF ? fh(p) : 0;
  };
  if (x < Lp) return fh(x) - (x >= 3 ? ffz(x - 3) : 0) > 0;
  const int k = x - Lp;
  return f[Lp - 3 + k] - ffz(Lp - 3 + k) > 0;
}

// ---- _frame_prefix_sums in _blocked_cumsum's order, both strands ----

// Level 0: task (strand, blk) scans the three class rows of positions
// 16 blk .. 16 blk + 15 in registers; the inner prefix of the class
// diagonal goes to R / Rr, the rows' block totals to level 1 (zeros past
// the last block).
template <typename S, class R>
__device__ __forceinline__ void prefix_level0(const Args& a, const R& r,
                                              int b) {
  const int Lp = r.Lp, n = r.n, nb1 = cdiv(Lp, 16), pb = pad16(nb1);
  const int LL = lev_len(Lp);
  S* lev = r.lev();
  const float* g = a.gene6 + (size_t)b * 6 * Lp;
  const float* h = a.ind6 + (size_t)b * 6 * Lp;
  for (int task = threadIdx.x; task < 2 * pb; task += T) {
    const bool fwd = task < pb;
    const int blk = fwd ? task : task - pb;
    S* up = lev + (fwd ? 0 : 3) * LL + blk;
    if (blk >= nb1) {
      up[0] = up[LL] = up[2 * LL] = (S)0;
      continue;
    }
    S* out = fwd ? r.R() : r.Rr();
    const int r0 = fwd ? 0 : 3;
    S acc0 = (S)0, acc1 = (S)0, acc2 = (S)0;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const int p = blk * 16 + k;
      S d0 = (S)0, d1 = (S)0, d2 = (S)0;  // rows 0-2 of the strand at p
      if (p < Lp && p < n) {
        const int col = fwd ? min(max(n - 1 - p, 0), Lp - 1) : p;
        d0 = (S)g[r0 * Lp + col] - (S)h[r0 * Lp + col];
        d1 = (S)g[(r0 + 1) * Lp + col] - (S)h[(r0 + 1) * Lp + col];
        d2 = (S)g[(r0 + 2) * Lp + col] - (S)h[(r0 + 2) * Lp + col];
      }
      // class row c reads row (c + 1 - p) % 3 (fwd) or (p - c) % 3 (rev)
      const int m = p % 3;
      const S v0 = fwd ? sel3((4 - m) % 3, d0, d1, d2) : sel3(m, d0, d1, d2);
      const S v1 = fwd ? sel3((5 - m) % 3, d0, d1, d2)
                       : sel3((m + 2) % 3, d0, d1, d2);
      const S v2 = fwd ? sel3((3 - m) % 3, d0, d1, d2)
                       : sel3((m + 1) % 3, d0, d1, d2);
      acc0 = k == 0 ? v0 : acc0 + v0;
      acc1 = k == 0 ? v1 : acc1 + v1;
      acc2 = k == 0 ? v2 : acc2 + v2;
      if (p < Lp) out[p] = sel3(m, acc0, acc1, acc2);
    }
    up[0] = acc0;
    up[LL] = acc1;
    up[2 * LL] = acc2;
  }
}

// Levels >= 1 of the six rows (three a strand), each lev_len(Lp) entries:
// a blocked level's inner scans put its block totals into the next level,
// the last level (<= 16 entries) is scanned sequentially, then each
// blocked level adds the exclusive totals of the level above it. Run by
// warp 0 alone (WARP, __syncwarp) or by the whole block (__syncthreads).
template <bool WARP, typename S>
__device__ __forceinline__ void prefix_levels(S* lev, int Lp) {
  const int me = WARP ? (threadIdx.x & 31) : threadIdx.x;
  const int stride = WARP ? 32 : T;
  auto sync = [] {
    if (WARP)
      __syncwarp();
    else
      __syncthreads();
  };
  const int LL = lev_len(Lp), nb1 = cdiv(Lp, 16);
  int m = nb1, off = 0, depth = 1;
  while (m > 16) {
    const int nb = cdiv(m, 16), pn = pad16(nb), offn = off + pad16(m);
    for (int i = me; i < 6 * pn; i += stride) {
      const int row = i / pn, blk = i % pn;
      S* up = lev + row * LL + offn;
      if (blk >= nb) {
        up[blk] = (S)0;
        continue;
      }
      S* x = lev + row * LL + off + blk * 16;
      S acc = x[0];
      for (int k = 1; k < 16; ++k) {
        acc = acc + x[k];
        x[k] = acc;
      }
      up[blk] = acc;
    }
    sync();
    m = nb;
    off = offn;
    ++depth;
  }
  for (int row = me; row < 6; row += stride) {
    S* x = lev + row * LL + off;
    S acc = x[0];
    for (int k = 1; k < m; ++k) {
      acc = acc + x[k];
      x[k] = acc;
    }
  }
  sync();
  // back down: level t (t = depth - 1 .. 1) += exclusive totals of t + 1
  for (int t = depth - 1; t >= 1; --t) {
    int mt = nb1, ot = 0;
    for (int j = 1; j < t; ++j) {
      ot += pad16(mt);
      mt = cdiv(mt, 16);
    }
    const int ou = ot + pad16(mt);
    for (int i = me; i < 6 * mt; i += stride) {
      const int row = i / mt, k = i % mt;
      S* x = lev + row * LL + ot;
      const S* up = lev + row * LL + ou;
      x[k] = x[k] + (k / 16 == 0 ? (S)0 : up[k / 16 - 1]);
    }
    sync();
  }
}

// The class diagonals: inner prefix + exclusive level-1 total of x's block.
template <typename S, class R>
__device__ __forceinline__ void prefix_final(const R& r) {
  const int Lp = r.Lp, LL = lev_len(Lp);
  const S* lev = r.lev();
  S *Rf = r.R(), *Rv = r.Rr();
  for (int i = threadIdx.x; i < 2 * Lp; i += T) {
    const bool fwd = i < Lp;
    const int x = fwd ? i : i - Lp, c = x % 3;
    S* out = fwd ? Rf : Rv;
    const S* up = lev + ((fwd ? 0 : 3) + c) * LL;
    out[x] = out[x] + (x / 16 == 0 ? (S)0 : up[x / 16 - 1]);
  }
}

// Minimum blocks an SM the kernel is compiled for (its registers: 65,536 /
// (T x blocks) a thread at most): the reads whose workspaces fit an SM's
// shared memory at Lp 768.
template <bool SUBS>
constexpr int min_blocks() {
  return SUBS ? 3 : 4;
}

template <typename S, bool RBS, bool SUBS, typename I>
__global__ void __launch_bounds__(T, min_blocks<SUBS>())
    frontend_kernel(typename std::conditional<SUBS, ArgsS, Args>::type a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int wbuf[(SUBS ? 24 : 18) * NW];
  __shared__ typename std::conditional<SUBS, TrS<S>, Tr<S>>::type tr;
  __shared__ S spen[4];

  using RD = typename std::conditional<SUBS, RdS<S, I>, Rd<S, I, SUBS>>::type;
  using K = typename std::conditional<sizeof(I) == 2, uint32_t,
                                      unsigned long long>::type;
  const int Lp = a.Lp, ncol = Lp / 3, N = SUBS ? 8 * Lp + 33 : 4 * Lp + 18;
  const int Eo = a.E < N ? a.E : N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  RD r;
  r.ws = a.scratch ? a.scratch + (size_t)blockIdx.x * (size_t)a.ws_bytes
                   : dsm;
  r.U = a16((size_t)Lp + 3);
  r.tmp = RD::L::tmp_off(Lp);
  r.Lp = Lp;
  r.mgl = a.mgl;
  {
    const int m3 = a.mgl - 3, lo = 3 < m3 ? 3 : m3;
    r.min_j = lo > m3 ? lo : m3;
  }
  r.LN = a.LN;
  r.W = a.W;
  r.rbw = a.rbw;
  r.ev = (S)a.ev_thresh;
  r.th = (S)a.start_thresh;
  if constexpr (SUBS) {
    if (tid < 4) spen[tid] = (S)a.pen[tid];
    r.pen = spen;
    r.cp = a.cp;
    r.two3 = (S)(2.0 / 3.0);
    r.one3 = (S)(1.0 / 3.0);
    const int m3 = a.mgl - 3;
    r.lowest_j = 3 < m3 ? 3 : m3;
  }
  int c0, c1;
  my_cols(ncol, c0, c1);

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int n = a.n[b];
    const int gi = clampi(a.groups[b], 0, a.G - 1);
    r.n = n;
    r.isl = a.isl[gi];
    r.prior = (S)a.prior[gi];
    r.len = a.len_score + (size_t)gi * 3 * a.LN;
    r.slo = a.start_lo + (size_t)gi * a.NS;
    r.nm = a.pwm_n[gi];
    r.is_user = a.pwm_is_user[gi] != 0;
    r.any_mode = r.is_user || r.nm > 0;
    const int* seq = a.seq + (size_t)b * Lp;
    if constexpr (SUBS) {
      r.seq = seq;
      r.q = a.quals ? a.quals + (size_t)b * Lp : nullptr;
    }

    // ---- phase 1: codon flags (_read_tables), RBS window scores
    // (_pwm_arrays), the prefix sums' level 0 ----
    {
      uint8_t* fl = r.fl();
      for (int i = tid; i < Lp; i += T) {
        int cod = 64;
        if (i >= 2 && i < n) cod = seq[i - 2] * 16 + seq[i - 1] * 4 + seq[i];
        cod = clampi(cod, 0, 64);
        const int o = gi * 65 + cod;
        const int wf = a.which_fwd[o], wr = a.which_rev[o];
        fl[i] = (uint8_t)((a.fwd_start[o] ? FS : 0) |
                          (a.rev_start[o] ? RS : 0) |
                          (a.fwd_stop[o] ? FT : 0) | (a.rev_stop[o] ? RT : 0) |
                          ((wf < 0 ? NONE : (wf > 2 ? 2 : wf)) << 4) |
                          ((wr < 0 ? NONE : (wr > 2 ? 2 : wr)) << 6));
      }
    }
    if (RBS) {
      const int C = a.C, WT = a.WT, W = a.W;
      const double* cols = a.pwm_cols + (size_t)gi * C * WT * 4;
      const double* ucols = a.pwm_user + (size_t)gi * WT * 4;
      const double* gcl = a.gc_lp + (size_t)gi * 4;
      const S denom = (S)(r.nm > 1 ? r.nm : 1);
      S *pwF = r.pwF(), *pwR = r.pwR();
      for (int p = tid; p < Lp; p += T) {
        S scf, scr;
        if (r.is_user) {
          S uf = (S)0, ur = (S)0;
          for (int j = 0; j < W; ++j) {
            const int sj = p + j < Lp ? clampi(seq[p + j], 0, 3) : 0;
            const int x = p + W - 1 - j;
            const int cj = x < Lp ? 3 - clampi(seq[x], 0, 3) : 0;
            uf = uf + (S)ucols[j * 4 + sj];
            ur = ur + (S)ucols[j * 4 + cj];
          }
          scf = uf;
          scr = ur;
        } else {
          S mf = (S)0, mr = (S)0, gf = (S)0, gr = (S)0;
          for (int c = 0; c < C; ++c) {
            S pf = (S)0, pr = (S)0;
            if (c < r.nm) {
              pf = (S)1;
              pr = (S)1;
              for (int j = 0; j < W; ++j) {
                const int sj = p + j < Lp ? clampi(seq[p + j], 0, 3) : 0;
                const int x = p + W - 1 - j;
                const int cj = x < Lp ? 3 - clampi(seq[x], 0, 3) : 0;
                const double* cc = cols + ((size_t)c * WT + j) * 4;
                pf = mul(pf, (S)cc[sj]);
                pr = mul(pr, (S)cc[cj]);
              }
            }
            mf = c == 0 ? pf : mf + pf;
            mr = c == 0 ? pr : mr + pr;
          }
          for (int j = 0; j < W; ++j) {
            const int sj = p + j < Lp ? clampi(seq[p + j], 0, 3) : 0;
            const int x = p + W - 1 - j;
            const int cj = x < Lp ? 3 - clampi(seq[x], 0, 3) : 0;
            gf = gf + (S)gcl[sj];
            gr = gr + (S)gcl[cj];
          }
          scf = lg(mf / denom) - gf;
          scr = lg(mr / denom) - gr;
        }
        pwF[p] = scf;
        pwR[p] = scr;
      }
    }
    prefix_level0<S>(a, r, b);
    __syncthreads();

    // ---- phase 2: the prefix sums' upper levels; the six frame-class
    // scans as one scan of 18 lanes: cummax of the fwd stops, rev stops and
    // rev starts, reverse cummin of the fwd stops, rev stops and fwd starts,
    // within each class i % 3 ----
    if (cdiv(Lp, 16) > 64)
      prefix_levels<false>(r.lev(), Lp);
    else if (warp == 0)
      prefix_levels<true>(r.lev(), Lp);
    {
      const uint8_t* fl = r.fl();
      int fx[9], rx[9], ft[9], rt[9];
#pragma unroll
      for (int l = 0; l < 9; ++l) {
        fx[l] = -BIG;
        rx[l] = BIG;
      }
      for (int c = c0; c < c1; ++c)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int i = 3 * c + k, f = fl[i];
          if (f & FT) fx[k] = i;
          if (f & RT) fx[3 + k] = i;
          if (f & RS) fx[6 + k] = i;
          if ((f & FT) && rx[k] == BIG) rx[k] = i;
          if ((f & RT) && rx[3 + k] == BIG) rx[3 + k] = i;
          if ((f & FS) && rx[6 + k] == BIG) rx[6 + k] = i;
        }
      scan_warp<false>(fx, MaxOp(), wbuf);
      scan_warp<true>(rx, MinOp(), wbuf + 9 * NW);
      __syncthreads();
      scan_block<false>(fx, ft, MaxOp(), -BIG, wbuf);
      scan_block<true>(rx, rt, MinOp(), BIG, wbuf + 9 * NW);
      // ---- phase 3: the scans' outputs; the class diagonals ----
      const Ix<I> psf = r.psf(), psr = r.psr(), pstr = r.pstr();
      const Ix<I> nsf = r.nsf(), nsr = r.nsr(), nstf = r.nstf();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        int a0 = fx[k], a1 = fx[3 + k], a2 = fx[6 + k];
        for (int c = c0; c < c1; ++c) {
          const int i = 3 * c + k, f = fl[i];
          if (f & FT) a0 = i;
          if (f & RT) a1 = i;
          if (f & RS) a2 = i;
          psf.set(i, a0);
          psr.set(i, a1);
          pstr.set(i, a2);
        }
        a0 = rx[k];
        a1 = rx[3 + k];
        a2 = rx[6 + k];
        for (int c = c1 - 1; c >= c0; --c) {
          const int i = 3 * c + k, f = fl[i];
          if (f & FT) a0 = i;
          if (f & RT) a1 = i;
          if (f & FS) a2 = i;
          nsf.set(i, a0);
          nsr.set(i, a1);
          nstf.set(i, a2);
        }
      }
    }
    prefix_final<S>(r);
    __syncthreads();

    // ---- phase 4: std start candidates, both strands ----
    {
      const uint8_t* fl = r.fl();
      const S *Rf = r.R(), *Rv = r.Rr();
      const Ix<I> nsf = r.nsf(), nsr = r.nsr(), psr = r.psr();
      for (int q = tid; q < Lp; q += T) {
        // forward: q is the start codon's first base
        {
          const int i_next = q + 5 < Lp ? nsf[q + 5] : BIG;
          const int vcls = pmod3(q + 2 - n);
          const int ivirt = n + vcls;
          const int iS = i_next < ivirt ? i_next : ivirt;
          const int sl = i_next < BIG ? i_next : Lp + vcls;
          const bool emit = fwd_slot<SUBS>(r, sl).emit;
          const bool is_real = iS < n;
          const int hi = iS - 2;
          int lo;
          if (is_real) {
            lo = q + 2 < Lp ? fwd_prev(r, q + 2) : 0;
          } else {
            const int xv = n + vcls - 3;
            const int fp = (xv >= 0 && xv < Lp) ? fwd_prev(r, xv) : 0;
            lo = xv >= 0 ? fp : xv;
          }
          lo += 1;
          const int top = topj(hi - lo);
          const int j = hi - 3 - q;
          const bool hit2 = q + 2 < Lp && (fl[q + 2] & FS);
          const int wc = q + 2 < Lp ? (fl[q + 2] >> 4) & 3 : NONE;
          const bool valid = emit && q >= lo && j >= r.min_j && j <= top &&
                             hit2;
          S av;
          if (sl < Lp) {
            av = sl >= 3 ? Rf[sl - 3] : (S)0;
          } else {
            const int xv = n + (sl - Lp) - 3;
            av = (xv >= 0 && xv < Lp) ? Rf[xv] : (S)0;
          }
          const S raw_nb = av - (q + 2 < Lp ? Rf[q + 2] : (S)0);
          const S raw = j + 2 > r.isl ? clamp0(raw_nb) : raw_nb;
          S pwm = (S)0;
          int sep = 0;
          if (RBS) best_f(r, q, pwm, sep);
          const S score = score_tail<S, RBS>(
              r, raw, pwm, sep, is_real ? 0 : 1,
              clampi(fdiv3(j) + 1, 0, r.LN - 1), wc);
          r.scoreF()[q] = score;
          r.cfF()[q] = (uint8_t)((valid && raw > r.th ? RAWOK : 0) |
                                 (valid && score > r.ev ? PASS : 0));
          if constexpr (SUBS) {
            // the sub-extension: the gene runs through q's closing stop s1
            // into the next slot's run (the suffix terms read at s1)
            int sj = 0;
            bool em2 = false, t32 = false;
            S suf = (S)0;
            if (i_next < BIG) {
              const int s2 = next_f(r, i_next);
              sj = mm2_f(r, i_next);
              em2 = fwd_slot<true>(r, s2).emit;
              t32 = s2 >= Lp;
              suf = suf_f(r, i_next);
            }
            const int mjs = r.mgl - 3 - sj > r.lowest_j ? r.mgl - 3 - sj
                                                         : r.lowest_j;
            const int jf = j + 2 + sj;
            const bool sv = is_real && em2 && q >= lo && j >= mjs &&
                            j <= top && hit2 && 1 + jf >= r.mgl;
            S rt = raw_nb + suf;
            if (jf > r.isl) rt = clamp0(rt);
            const S ss = score_tail<S, RBS>(
                r, rt, pwm, sep, t32 ? 1 : 0,
                clampi(fdiv3(j + sj) + 1, 0, r.LN - 1), wc);
            r.scoreSF()[q] = ss;
            r.cfSF()[q] = (uint8_t)((sv && rt > r.th ? RAWOK : 0) |
                                    (sv && ss > r.ev ? PASS : 0));
          }
        }
        // reverse: u = q is the start codon's last base
        {
          const int u = q, c = u % 3;
          const int i_close = u + 3 < Lp ? nsr[u + 3] : BIG;
          const bool is_real = i_close < HALF;
          const int sl = is_real ? i_close : Lp + c;
          const bool emit = rev_slot<SUBS>(r, sl).emit;
          const int ip = psr[u];
          const bool hp = ip > -HALF;
          const int orf_stop = hp ? ip - 1 : vstop(c);
          const int lo = orf_stop + 3, x_ep = lo - 1;
          const int fr = pmod3(n - 1 - x_ep);
          const int init = fr == 0 ? n - 1 : (fr == 1 ? n - 2 : n);
          const int cl = is_real ? i_close - 2 : BIG;
          const int rn = init < cl ? init : cl;
          const int hi = ((x_ep >= 0 && x_ep < n) ? rn : x_ep) + 1;
          const int top = topj(hi - lo);
          const int j = u - lo - 1;
          const bool valid = emit && (fl[u] & RS) && j >= r.min_j &&
                             j <= top && u <= hi - 2;
          const int wc = (fl[u] >> 6) & 3;
          const S av = u >= 3 ? Rv[u - 3] : (S)0;
          const S bv = hp ? Rv[ip]
                          : (c == 0 ? Rv[0] : (c == 1 ? Rv[1] : (S)0));
          const S raw_nb = av - bv;
          const S raw = j + 2 > r.isl ? clamp0(raw_nb) : raw_nb;
          S pwm = (S)0;
          int sep = 0;
          if (RBS) best_r(r, u, pwm, sep);
          const S score = score_tail<S, RBS>(
              r, raw, pwm, sep, orf_stop < 1 ? 1 : 0,
              clampi(fdiv3(j) + 1, 0, r.LN - 1), wc);
          r.scoreR()[u] = score;
          r.cfR()[u] = (uint8_t)((valid && raw > r.th ? RAWOK : 0) |
                                 (valid && score > r.ev ? PASS : 0));
          if constexpr (SUBS) {
            // the sub-extension: the ORF s2 before u's (closing stop ip)
            // extends right through ip into u's run
            int sj = 0;
            bool em2 = false, t32 = false;
            S suf = (S)0;
            if (hp) {
              const Slot o2 = rev_slot<true>(r, ip);
              em2 = o2.emit;
              sj = o2.mm;
              t32 = o2.t3;
              suf = suf_r(r, ip);
            }
            const int mjs = r.mgl - 3 - sj > r.lowest_j ? r.mgl - 3 - sj
                                                         : r.lowest_j;
            const int jf = j + 2 + sj;
            const bool sv = hp && em2 && (fl[u] & RS) && j >= mjs &&
                            j <= top && u <= hi - 2 && 1 + jf >= r.mgl;
            S rt = raw_nb + suf;
            if (jf > r.isl) rt = clamp0(rt);
            const S ss = score_tail<S, RBS>(
                r, rt, pwm, sep, t32 ? 1 : 0,
                clampi(fdiv3(j + sj) + 1, 0, r.LN - 1), wc);
            r.scoreSR()[u] = ss;
            r.cfSR()[u] = (uint8_t)((sv && rt > r.th ? RAWOK : 0) |
                                    (sv && ss > r.ev ? PASS : 0));
          }
        }
      }
    }
    __syncthreads();

    // ---- phase 5: truncated first/last starts, 6 a strand: entry e on
    // lane e % 3 of warp e / 3 (forward 0-2, forward 3-5, reverse 0-2,
    // reverse 3-5), so that no warp runs both strands' paths ----
    if (lane < 3 && warp < 4) {
      const int e = warp * 3 + lane;
      const bool fwd = e < 6;
      const int k = fwd ? e : e - 6;
      int slot6;
      bool v6;
      if (k < 3) {
        if (fwd) {
          const int fs = r.nsf()[k];
          v6 = fs < HALF;
          slot6 = v6 ? fs : -1;
        } else {
          const int ls = r.psr()[Lp - 3 + k];
          v6 = ls > -HALF;
          slot6 = v6 ? ls : -1;
        }
      } else {
        slot6 = Lp + k - 3;
        v6 = true;
      }
      const int sc = clampi(slot6, 0, Lp + 2);
      const Slot sl = fwd ? fwd_slot<SUBS>(r, sc) : rev_slot<SUBS>(r, sc);
      const bool tv = sl.emit && v6 && sl.trunc && sl.mm >= 1 &&
                      sl.top >= r.min_j;
      const S* D = fwd ? r.R() : r.Rr();
      auto G = [&](int x) { return (x >= 0 && x < Lp) ? D[x] : (S)0; };
      int qt, pos, sub;
      S raw_nb;
      if (fwd) {
        qt = sl.hi - 3 - sl.top;
        raw_nb = G(sl.hi - 1) - G(sl.hi - 1 - sl.top);
        pos = qt + 3;
        sub = (pmod3(sl.iS) + 1) % 3;
      } else {
        qt = sl.lo + sl.top + 1;
        raw_nb = G(sl.lo - 2 + sl.top) - (sl.lo >= 2 ? G(sl.lo - 2) : (S)0);
        pos = qt + 1;
        const int cs = sc < Lp ? sc % 3 : sc - Lp;
        sub = 3 + (cs + 1) % 3;
      }
      const S raw = sl.top + 2 > r.isl ? clamp0(raw_nb) : raw_nb;
      const bool inr = qt >= 0 && qt < Lp;
      S pwm = (S)0;
      int sep = 0;
      if (RBS && inr) {
        if (fwd)
          best_f(r, qt, pwm, sep);
        else
          best_r(r, qt, pwm, sep);
      }
      const S st = score_tail<S, RBS>(r, raw, pwm, sep, sl.t3 ? 2 : 1,
                                      clampi(fdiv3(sl.top) + 1, 0, r.LN - 1),
                                      NONE);
      const bool tp = tv && st > r.ev;
      const uint8_t* cf = fwd ? r.cfF() : r.cfR();
      const S* scs = fwd ? r.scoreF() : r.scoreR();
      const bool std_at = inr && (cf[qt] & PASS);
      const S ss = inr ? scs[qt] : neg_inf<S>();
      tr.slot[e] = slot6;
      tr.slotc[e] = sc;
      tr.q[e] = qt;
      tr.pos[e] = pos;
      tr.sub[e] = sub;
      tr.fin[e] = tp && !(std_at && ss > st);
      tr.kill[e] = tp && (ss <= st);
      tr.raw[e] = tv && raw > r.th;
      tr.score[e] = st;
      if constexpr (SUBS) {
        // the truncated sub entries: forward the first ORF of each class
        // chain extended into its next slot (s2slot6); reverse each
        // truncated ORF extended from its previous slot
        if (!fwd || k < 3) {
          const int es = fwd ? k : 3 + k;
          int s2, sj, epos;
          bool ok, em2, t32;
          S suf;
          if (fwd) {
            const int nk = r.nsf()[k];
            const int fs = nk < Lp - 1 ? nk : Lp - 1;
            s2 = next_f(r, fs);
            ok = v6;
            sj = mm2_f(r, fs);
            em2 = fwd_slot<true>(r, s2).emit;
            t32 = s2 >= Lp;
            suf = suf_f(r, fs);
            epos = v6 ? nk - 1 : -1;
          } else {
            const int ls = r.psr()[Lp - 3 + (k < 3 ? k : k - 3)];
            if (k < 3) {
              const int x = clampi(ls, 0, Lp - 1) - 3;
              const int pp3 = x >= 0 ? r.psr()[x] : -BIG;
              ok = ls > -HALF && pp3 > -HALF;
              s2 = ok ? pp3 : 0;
            } else {
              ok = ls > -HALF;
              s2 = ok ? ls : 0;
            }
            const Slot o2 = rev_slot<true>(r, s2);
            em2 = o2.emit && ok;
            sj = o2.mm;
            t32 = o2.t3;
            suf = suf_r(r, s2);
            epos = ok ? s2 + 1 : -1;
          }
          const int mjs = r.mgl - 3 - sj > r.lowest_j ? r.mgl - 3 - sj
                                                       : r.lowest_j;
          const int jf = sl.top + 2 + sj;
          const bool sv = ok && em2 && sl.trunc && sl.mm >= 1 &&
                          sl.top >= mjs && 1 + jf >= r.mgl;
          S r6 = raw_nb + suf;
          if (jf > r.isl) r6 = clamp0(r6);
          const S s6 = score_tail<S, RBS>(
              r, r6, pwm, sep, t32 ? 2 : 1,
              clampi(fdiv3(sl.top + sj) + 1, 0, r.LN - 1), NONE);
          const bool sp = sv && s6 > r.ev;
          const uint8_t* scf = fwd ? r.cfSF() : r.cfSR();
          const S* sss = fwd ? r.scoreSF() : r.scoreSR();
          const bool sat = inr && (scf[qt] & PASS);
          const S ssc = inr ? sss[qt] : neg_inf<S>();
          tr.s2[es] = s2;
          tr.epos[es] = epos;
          tr.ok[es] = ok;
          tr.sfin[es] = sp && !(sat && ssc > s6);
          tr.skill[es] = sp && (ssc <= s6);
          tr.sraw[es] = sv && r6 > r.th;
          tr.sscore[es] = s6;
        }
      }
    }
    __syncthreads();

    // ---- phase 6: _dedup on the thread's columns (std entries a truncated
    // entry kills), then the class cumsums of the candidate indicators
    // (RAWOK and FINAL of cfF, cfR [, cfSF, cfSR]) as one scan of 12 (24)
    // lanes, lane 3 j + class for indicator j ----
    {
      constexpr int NJ = SUBS ? 8 : 4, NL = 3 * NJ;
      uint8_t *cfF = r.cfF(), *cfR = r.cfR();
      auto kills = [&](int q, int e0, int ne, const uint8_t* kl) {
        bool kk = false;
        for (int k = 0; k < ne; ++k) kk = kk || (q == tr.q[e0 + k] && kl[k]);
        return kk;
      };
      // the indicator bits of position q: j = 0..NJ-1
      auto ind = [&](int q, int j) {
        const uint8_t f = j < 2 ? cfF[q]
                        : j < 4 ? cfR[q]
                        : j < 6 ? r.cfSF()[q] : r.cfSR()[q];
        return (f & (j % 2 ? FINAL : RAWOK)) ? 1 : 0;
      };
      int v[NL], tot[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) v[l] = 0;
      for (int c = c0; c < c1; ++c)
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          const int q = 3 * c + kk;
          if ((cfF[q] & PASS) && !kills(q, 0, 6, tr.kill)) cfF[q] |= FINAL;
          if ((cfR[q] & PASS) && !kills(q, 6, 6, tr.kill + 6))
            cfR[q] |= FINAL;
          if constexpr (SUBS) {
            uint8_t *cfSF = r.cfSF(), *cfSR = r.cfSR();
            if ((cfSF[q] & PASS) && !kills(q, 0, 3, tr.skill))
              cfSF[q] |= FINAL;
            if ((cfSR[q] & PASS) && !kills(q, 6, 6, tr.skill + 3))
              cfSR[q] |= FINAL;
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) v[3 * j + kk] += ind(q, j);
        }
      scan_warp<false>(v, AddOp(), wbuf);
      __syncthreads();
      scan_block<false>(v, tot, AddOp(), 0, wbuf);
#pragma unroll
      for (int kk = 0; kk < 3; ++kk)
        for (int c = c0; c < c1; ++c) {
          const int q = 3 * c + kk;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            v[3 * j + kk] += ind(q, j);
            r.F(j).set(q, v[3 * j + kk]);
          }
        }
    }
    __syncthreads();

    // ---- phase 7: the per-slot event gates of the thread's columns (and
    // of end slot Lp + tid for tid < 3), and the event-set ids
    // (_assign_ids) as one scan: ranks in the order, for s ascending,
    // (error-free) rev s, fwd s, or (substitution mode) rev clean, rev
    // sub, fwd sub, fwd clean; then the rev end slots, then the fwd end
    // slots, read off the scan's total. The gates are final at the scan's
    // barrier, so the assembly's validity bitmap (one warp ballot a word of
    // 32 candidates) is made in the same phase ----
    {
      uint8_t *evF = r.evF(), *evR = r.evR();
      auto gate = [&](int x) {
        bool fr6 = false, fa6 = false, rr6 = false, ra6 = false;
        for (int k = 0; k < 6; ++k) {
          if (x == tr.slot[k]) {
            fr6 = fr6 || tr.raw[k];
            fa6 = fa6 || tr.fin[k];
          }
          if (x == tr.slot[6 + k]) {
            rr6 = rr6 || tr.raw[6 + k];
            ra6 = ra6 || tr.fin[6 + k];
          }
        }
        if constexpr (SUBS) {
          bool fs6 = false, fsa6 = false, rs6 = false, rsa6 = false;
          for (int k = 0; k < 9; ++k) {
            if (!tr.ok[k] || x != tr.s2[k]) continue;
            if (k < 3) {
              fs6 = fs6 || tr.sraw[k];
              fsa6 = fsa6 || tr.sfin[k];
            } else {
              rs6 = rs6 || tr.sraw[k];
              rsa6 = rsa6 || tr.sfin[k];
            }
          }
          const int ip = prev_f(r, x);
          const bool exf = (ip > -HALF && seg_f(r, r.F(4), ip)) || fs6;
          const bool anf = (ip > -HALF && seg_f(r, r.F(5), ip)) || fsa6;
          const bool clf = seg_f(r, r.F(1), x) || fa6;
          const bool ef = fwd_slot<true>(r, x).emit &&
                          (seg_f(r, r.F(0), x) || fr6 || exf) &&
                          (clf || anf);
          const int nx = x < Lp ? slot_mr(r, x) : -1;
          const bool exr = (nx >= 0 && seg_r(r, r.F(6), nx)) || rs6;
          const bool anr = (nx >= 0 && seg_r(r, r.F(7), nx)) || rsa6;
          const bool clr = seg_r(r, r.F(3), x) || ra6;
          const bool er = rev_slot<true>(r, x).emit &&
                          (seg_r(r, r.F(2), x) || rr6 || exr) &&
                          (clr || anr);
          evF[x] = (uint8_t)((ef ? EVP : 0) | (ef && clf ? CLN : 0) |
                             (ef && anf ? SUBB : 0));
          evR[x] = (uint8_t)((er ? EVP : 0) | (er && clr ? CLN : 0) |
                             (er && anr ? SUBB : 0));
        } else {
          const bool ef = fwd_slot<false>(r, x).emit &&
                          (seg_f(r, r.F(0), x) || fr6) &&
                          (seg_f(r, r.F(1), x) || fa6);
          const bool er = rev_slot<false>(r, x).emit &&
                          (seg_r(r, r.F(2), x) || rr6) &&
                          (seg_r(r, r.F(3), x) || ra6);
          evF[x] = ef;
          evR[x] = er;
        }
      };
      // the ids slot s takes, in their order (j < NPER)
      constexpr int NPER = SUBS ? 4 : 2;
      auto idbit = [&](int s, int j) {
        if (!SUBS) return (int)(j == 0 ? evR[s] : evF[s]);
        const uint8_t g = j < 2 ? evR[s] : evF[s];
        const uint8_t m = (j == 0 || j == 3) ? CLN : SUBB;
        return (g & m) ? 1 : 0;
      };
      int v[1] = {0}, tot[1];
      for (int s = 3 * c0; s < 3 * c1; ++s) {
        gate(s);
#pragma unroll
        for (int j = 0; j < NPER; ++j) v[0] += idbit(s, j);
      }
      if (tid < 3) gate(Lp + tid);
      scan_warp<false>(v, AddOp(), wbuf);
      __syncthreads();
      scan_block<false>(v, tot, AddOp(), 0, wbuf);
      // the id arrays in the order of idbit's j
      auto ids = [&](int j) {
        if constexpr (SUBS)
          return sel3(j, r.idR(), r.idSR(), j == 2 ? r.idSF() : r.idF());
        else
          return j == 0 ? r.idR() : r.idF();
      };
      int run = v[0];
      for (int s = 3 * c0; s < 3 * c1; ++s)
#pragma unroll
        for (int j = 0; j < NPER; ++j) {
          run += idbit(s, j);
          ids(j).set(s, run);
        }
      // end slots: the 3 rev end slots' ids (j < NPER / 2 each), then the
      // 3 fwd end slots' (the others), after the scan's total
      constexpr int H = NPER / 2, NE = 3 * NPER;
      if (tid < NE) {
        auto at = [&](int e, int& s, int& j) {
          const bool rev = e < 3 * H;
          const int ee = rev ? e : e - 3 * H;
          s = Lp + ee / H;
          j = (rev ? 0 : H) + ee % H;
        };
        int acc = tot[0], s, j;
        for (int e = 0; e <= tid; ++e) {
          at(e, s, j);
          acc += idbit(s, j);
        }
        at(tid, s, j);
        ids(j).set(s, acc);
      }
      // the validity bitmap of the N candidates
      unsigned* bits = r.bits();
      for (int wd = warp; wd < cdiv(N, 32); wd += NW) {
        const int i = wd * 32 + lane;
        bool valid = false;
        if (i < N) {
          if constexpr (SUBS)
            valid = item_s(r, tr, i).valid;
          else
            valid = item(r, tr, i).valid;
        }
        const unsigned m = __ballot_sync(FULL, valid);
        if (lane == 0) bits[wd] = m;
      }
    }
    __syncthreads();

    // ---- phase 8: event assembly. The thread's words of the bitmap are
    // counted and compacted by a block scan; valid candidates put their
    // sort keys at their compacted positions, the first invalid ones fill
    // the rows past the events; then each valid candidate's row is its
    // key's rank ----
    {
      const unsigned* bits = r.bits();
      void* keys = r.keys();
      const int nwd = cdiv(N, 32), KW = cdiv(nwd, T);
      const int w0 = min(tid * KW, nwd), w1 = min(w0 + KW, nwd);
      int v[1] = {0}, tot[1];
      for (int wd = w0; wd < w1; ++wd) v[0] += __popc(bits[wd]);
      scan_warp<false>(v, AddOp(), wbuf);
      __syncthreads();
      scan_block<false>(v, tot, AddOp(), 0, wbuf);
      const int nv = tot[0];
      const size_t ob = (size_t)b * Eo;
      S* o_score = (S*)a.o_score;
      auto cand = [&](int i) {
        if constexpr (SUBS)
          return item_s(r, tr, i);
        else
          return item(r, tr, i);
      };
      using It = decltype(cand(0));
      auto put = [&](int row, const It& it, int typ) {
        a.o_pos[ob + row] = it.pos;
        a.o_typ[ob + row] = typ;
        a.o_sub[ob + row] = it.sub;
        a.o_id[ob + row] = it.id;
        o_score[ob + row] = it.score;
        a.o_trunc[ob + row] = it.trunc;
        if constexpr (SUBS) {
          a.o_err_pos[ob + row] = it.err_pos;
          a.o_err_typ[ob + row] = it.err_typ;
        }
      };
      int vp = v[0];
      for (int wd = w0; wd < w1; ++wd) {
        const unsigned m = bits[wd];
        for (int j = 0; j < 32; ++j) {
          const int i = wd * 32 + j;
          if (i >= N) break;
          if ((m >> j) & 1u) {
            const It it = cand(i);
            int tk = 0;
            if constexpr (SUBS) tk = it.tk;
            put_key(keys, vp++, it.pos, tk, I());
          } else if (nv + (i - vp) < Eo) {
            put(nv + (i - vp), cand(i), 0);
          }
        }
      }
      if (tid == 0) a.o_nev[b] = nv;
      __syncthreads();
      vp = v[0];
      for (int wd = w0; wd < w1; ++wd) {
        unsigned m = bits[wd];
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1;
          const int row = key_rank<K>(keys, vp++, nv);
          if (row < Eo) {
            const It it = cand(wd * 32 + j);
            put(row, it, it.typ);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The launch's attributes: with the workspace in shared memory (dyn bytes)
// the whole carveout goes to shared memory, so that min_blocks() reads fit
// on an SM; on the global-scratch route the CUDA default (L1 for the
// workspace).
template <typename S, bool RBS, bool SUBS, typename I>
cudaError_t attributes(size_t dyn) {
  auto k = frontend_kernel<S, RBS, SUBS, I>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributePreferredSharedMemoryCarveout,
      dyn ? cudaSharedmemCarveoutMaxShared : cudaSharedmemCarveoutDefault);
  if (e != cudaSuccess || dyn <= 48 * 1024) return e;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)dyn);
}

template <typename S, bool RBS, bool SUBS, typename I, class A>
int launch(const A& a, int grid, cudaStream_t st) {
  const size_t dyn = a.scratch ? 0 : (size_t)a.ws_bytes;
  const cudaError_t e = attributes<S, RBS, SUBS, I>(dyn);
  if (e != cudaSuccess) return (int)e;
  frontend_kernel<S, RBS, SUBS, I><<<grid, T, dyn, st>>>(a);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a read's workspace may take: as much as leaves
// room for SMEM_MIN_BLOCKS blocks an SM (their static shared memory and
// the runtime's reservation included) and fits one block's limit. A
// larger workspace takes the global-scratch route, which runs
// min_blocks() blocks an SM. Measured on the H100 at Lp 2,304 (PERF.md
// section 6): that route is 1.6x faster error-free f64 and 1.3-1.5x in
// substitution mode than the workspace in shared memory at one block an
// SM, the room a block may opt into.
constexpr int SMEM_MIN_BLOCKS = 2;

template <typename S, bool RBS, bool SUBS, typename I>
int smem_room() {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, frontend_kernel<S, RBS, SUBS, I>);
  if (e != cudaSuccess) return -(int)e;
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return -(int)e;
  const int st = (int)at.sharedSizeBytes;
  const int share = per_sm / SMEM_MIN_BLOCKS - reserved - st;
  return share < optin - st ? share : optin - st;
}

template <typename S, bool RBS, bool SUBS, typename I>
int occupancy(int Lp) {
  const int room = smem_room<S, RBS, SUBS, I>();
  if (room < 0) return room;
  size_t dyn = ws_bytes(Lp, (int)sizeof(S), SUBS);
  if (dyn > (size_t)room) dyn = 0;  // the global-scratch route
  cudaError_t e = attributes<S, RBS, SUBS, I>(dyn);
  if (e != cudaSuccess) return -(int)e;
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, frontend_kernel<S, RBS, SUBS, I>, T, dyn);
  return e != cudaSuccess ? -(int)e : nb;
}

// f.template run<S, RBS, I>() for the instantiation of (f64, rbs, Lp).
template <class F>
int dispatch(int f64, int rbs, int Lp, const F& f) {
  const bool nar = Lp < NARROW_LP;
  if (f64) {
    if (rbs)
      return nar ? f.template run<double, true, int16_t>()
                 : f.template run<double, true, int>();
    return nar ? f.template run<double, false, int16_t>()
               : f.template run<double, false, int>();
  }
  if (rbs)
    return nar ? f.template run<float, true, int16_t>()
               : f.template run<float, true, int>();
  return nar ? f.template run<float, false, int16_t>()
             : f.template run<float, false, int>();
}

template <bool SUBS, class A>
struct Launch {
  const A& a;
  int grid;
  cudaStream_t st;
  template <typename S, bool RBS, typename I>
  int run() const {
    return launch<S, RBS, SUBS, I>(a, grid, st);
  }
};

template <bool SUBS>
struct Occupancy {
  int Lp;
  template <typename S, bool RBS, typename I>
  int run() const {
    return occupancy<S, RBS, SUBS, I>(Lp);
  }
};

template <bool SUBS>
struct Room {
  template <typename S, bool RBS, typename I>
  int run() const {
    return smem_room<S, RBS, SUBS, I>();
  }
};

}  // namespace

// Bytes of one read's workspace at Lp (f64 or f32 carry; error-free or
// substitution mode).
extern "C" long long gmt_frontend_ws(int Lp, int f64, int subs) {
  return (long long)ws_bytes(Lp, f64 ? 8 : 4, subs != 0);
}

// Dynamic shared memory a read's workspace may take on the current device
// before it goes to the global-scratch route (smem_room; a negative
// cudaError on failure); the narrow and the wide index type's
// instantiations hold the same static shared memory.
extern "C" int gmt_frontend_smem_room(int f64, int rbs, int subs) {
  return subs ? dispatch(f64, rbs, 0, Room<true>())
              : dispatch(f64, rbs, 0, Room<false>());
}

// Blocks of the instantiation an SM holds at Lp (its workspace in shared
// memory when it fits, else the global-scratch route's block); a negative
// cudaError on failure.
extern "C" int gmt_frontend_occupancy(int f64, int rbs, int subs, int Lp) {
  return subs ? dispatch(f64, rbs, Lp, Occupancy<true>{Lp})
              : dispatch(f64, rbs, Lp, Occupancy<false>{Lp});
}

// Lp below which the narrow index type's instantiations run.
extern "C" int gmt_frontend_narrow_lp() { return NARROW_LP; }

// One launch over B reads. ``scratch`` null: each block's workspace is
// ws_bytes of dynamic shared memory; else ``grid`` blocks each use their
// ws_bytes slice of scratch. With ``subs`` the substitution mode: ``quals``
// (B, Lp) uint8 or null (then the penalties pen[2 * mid + last]), ``cp``
// the 256 doubles of _CP_TAB, and the error rows o_err_pos / o_err_typ.
// Returns cudaGetLastError() after the launch.
extern "C" int gmt_frontend(
    const void* seq, const void* n, const void* groups, const void* gene6,
    const void* ind6, const void* fwd_start, const void* rev_start,
    const void* fwd_stop, const void* rev_stop, const void* which_fwd,
    const void* which_rev, const void* prior, const void* start_lo,
    const void* len_score, const void* isl, const void* pwm_cols,
    const void* pwm_n, const void* pwm_user, const void* pwm_is_user,
    const void* gc_lp, void* o_pos, void* o_typ, void* o_sub, void* o_id,
    void* o_score, void* o_trunc, void* o_nev, void* scratch,
    long long ws_bytes, int grid, int B, int Lp, int G, int NS, int LN, int C,
    int WT, int W, int rbw, int mgl, int E, int f64, double ev_thresh,
    double start_thresh, int subs, const void* quals, const void* cp,
    void* o_err_pos, void* o_err_typ, double pen_ff, double pen_ft,
    double pen_tf, double pen_tt, void* stream) {
  ArgsS a;
  a.seq = static_cast<const int*>(seq);
  a.n = static_cast<const int*>(n);
  a.groups = static_cast<const int*>(groups);
  a.gene6 = static_cast<const float*>(gene6);
  a.ind6 = static_cast<const float*>(ind6);
  a.fwd_start = static_cast<const uint8_t*>(fwd_start);
  a.rev_start = static_cast<const uint8_t*>(rev_start);
  a.fwd_stop = static_cast<const uint8_t*>(fwd_stop);
  a.rev_stop = static_cast<const uint8_t*>(rev_stop);
  a.which_fwd = static_cast<const int*>(which_fwd);
  a.which_rev = static_cast<const int*>(which_rev);
  a.prior = static_cast<const float*>(prior);
  a.start_lo = static_cast<const float*>(start_lo);
  a.len_score = static_cast<const double*>(len_score);
  a.isl = static_cast<const int*>(isl);
  a.pwm_cols = static_cast<const double*>(pwm_cols);
  a.pwm_n = static_cast<const int*>(pwm_n);
  a.pwm_user = static_cast<const double*>(pwm_user);
  a.pwm_is_user = static_cast<const uint8_t*>(pwm_is_user);
  a.gc_lp = static_cast<const double*>(gc_lp);
  a.o_pos = static_cast<int*>(o_pos);
  a.o_typ = static_cast<int*>(o_typ);
  a.o_sub = static_cast<int*>(o_sub);
  a.o_id = static_cast<int*>(o_id);
  a.o_score = o_score;
  a.o_trunc = static_cast<uint8_t*>(o_trunc);
  a.o_nev = static_cast<int*>(o_nev);
  a.scratch = static_cast<uint8_t*>(scratch);
  a.ws_bytes = ws_bytes;
  a.B = B;
  a.Lp = Lp;
  a.G = G;
  a.NS = NS;
  a.LN = LN;
  a.C = C;
  a.WT = WT;
  a.W = W;
  a.rbw = rbw;
  a.mgl = mgl;
  a.E = E;
  a.ev_thresh = ev_thresh;
  a.start_thresh = start_thresh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rbs = W > 0;
  if (!subs)
    return dispatch(f64, rbs, Lp,
                    Launch<false, Args>{static_cast<const Args&>(a), grid,
                                        st});
  a.quals = static_cast<const uint8_t*>(quals);
  a.cp = static_cast<const double*>(cp);
  a.o_err_pos = static_cast<int*>(o_err_pos);
  a.o_err_typ = static_cast<int*>(o_err_typ);
  a.pen[0] = pen_ff;
  a.pen[1] = pen_ft;
  a.pen[2] = pen_tf;
  a.pen[3] = pen_tt;
  return dispatch(f64, rbs, Lp, Launch<true, ArgsS>{a, grid, st});
}
