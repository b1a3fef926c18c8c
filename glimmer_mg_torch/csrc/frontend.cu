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
// The mode is a template parameter (SUBS), so the error-free instantiation
// compiles as it did before the substitution mode was added; the
// substitution mode's state (its arrays, slot flags, entries and arguments)
// lives in types derived from the error-free ones and only that
// instantiation carries it. Substitution mode adds, a strand, the
// sub-extension families: a start whose gene runs through its ORF's stop
// codon, read as a sequencing error at the stop penalty, into the next ORF
// of the frame (std, one a position; truncated, 3 forward and 6 reverse);
// ORFs of frame length >= 15 are kept (indel_orfs); each (ORF, error set)
// gets its own id and stop event; equal positions keep the reference's
// insertion order (tiekey). Its 8 Lp + 33 candidates are sorted on
// (pos, tiekey, index), which is the twin's two stable argsorts.
//
// What bounds it: not bytes. A 2,048-read chunk at Lp 768 moves about
// 90 MB (the reads, K1's two (B, 6, Lp) f32 tables, the event rows), 27
// microseconds at 3.35 TB/s. A read is a chain of block-wide steps (class
// scans, a blocked prefix sum, the candidate sort), each a few barriers,
// over a working set of 60-90 KB a read, so the kernel is held by barrier
// latency and by how many reads' working sets fit in shared memory at once.
//
// Design: one block of T threads a read (a grid-stride loop over reads).
// Thread t owns a contiguous run of codon columns (positions 3c..3c+2), so
// a frame-class scan (cummax, reverse cummin, cumsum within i % 3) is a
// sequential pass over the thread's columns plus one block scan of three
// lanes. The read's working arrays (codon flags, the six stop/start scans,
// the two class-diagonal prefix sums, the RBS window scores, the std start
// scores, the per-slot event gates and ids, the sort keys) sit in one
// workspace of layout() bytes: dynamic shared memory when it fits on the
// card, else a slice of a global scratch buffer the wrapper allocates (the
// grid is then a few blocks an SM). Group tables are read by group from the
// bank. Per-slot ORF fields (Do_*_Stop_Codon's lo, hi, emit ...) are
// recomputed where they are read, from the scans. The valid candidates are
// compacted in the twin's concatenation order (std_f, tr_f, stop_f, std_r,
// tr_r, stop_r) by a block prefix sum and sorted on (pos, index) by a
// bitonic network in the workspace; invalid candidates fill the rows past a
// read's events in concatenation order, as the twin's stable argsort puts
// them. No host sync, no device-side assert, no allocation.
//
// Where bitwise equality is at risk, and what the code does about it:
//  * _blocked_cumsum's order: a sequential inclusive scan inside blocks of
//    16 (the first element taken as it is), the block totals scanned the
//    same way recursively while there are more than 16 (else sequentially),
//    then inner + exclusive total, with +0.0 added in the first block. The
//    levels and their zero padding are those of the twin; no tree scan.
//    Only the class diagonal R[x] = S[x % 3][x] of each strand's three rows
//    is kept: every read of the prefix sums is on it.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int T = 256;  // threads a block
constexpr int BIG = 1 << 29;
constexpr int HALF = BIG / 2;  // BIG // 2
constexpr int MAXLEV = 8;      // prefix-sum levels (Lp < 16^7)
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
// the sort key of a substitution-mode candidate: pos, tiekey, index
constexpr long long TK_SHIFT = 1LL << 22, POS_SHIFT = 1LL << 44;

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

// Byte offsets of a read's arrays in its workspace.
struct Layout {
  size_t fl, psf, nsf, psr, nsr, nstf, pstr;  // flags; the six class scans
  size_t scoreF, scoreR, cfF, cfR;            // std candidates
  size_t evF, evR, idF, idR;                  // slots (Lp + 3)
  size_t R, Rr, rows, pwF, pwR;               // phase 1 of the temp region
  size_t F, keys;                             // phases 2 and 3 (aliases)
  size_t total;
  int rowlen, nlev;
  int lev_n[MAXLEV], lev_off[MAXLEV];
};

// Bytes of the substitution mode's own arrays, which follow idR: the sub
// std scores of each strand (S, Lp), their candidate bits (Lp) and the sub
// ids of each strand's slots (int, Lp + 3).
__host__ __device__ inline size_t subs_bytes(int Lp, int sz) {
  const size_t lp = (size_t)Lp, ls = lp + 3;
  return 2 * a16(sz * lp) + 2 * a16(lp) + 2 * a16(4 * ls);
}

__host__ __device__ inline Layout make_layout(int Lp, int sz,
                                              bool subs = false) {
  Layout L;
  // _blocked_cumsum's levels: level 0 (Lp entries) always blocked; level l
  // holds the block totals of level l - 1 and is blocked while > 16
  L.nlev = 1;
  L.lev_n[0] = Lp;
  L.lev_off[0] = 0;
  int off = pad16(Lp), cur = Lp;
  for (;;) {
    const int nb = cdiv(cur, 16);
    L.lev_n[L.nlev] = nb;
    L.lev_off[L.nlev] = off;
    L.nlev++;
    off += pad16(nb);
    if (nb <= 16 || L.nlev == MAXLEV) break;
    cur = nb;
  }
  L.rowlen = off;
  const size_t lp = (size_t)Lp, ls = lp + 3;
  size_t o = 0;
  L.fl = o;
  o += a16(lp);
  size_t* scans[6] = {&L.psf, &L.nsf, &L.psr, &L.nsr, &L.nstf, &L.pstr};
  for (int k = 0; k < 6; ++k) {
    *scans[k] = o;
    o += a16(4 * lp);
  }
  L.scoreF = o;
  o += a16(sz * lp);
  L.scoreR = o;
  o += a16(sz * lp);
  L.cfF = o;
  o += a16(lp);
  L.cfR = o;
  o += a16(lp);
  L.evF = o;
  o += a16(ls);
  L.evR = o;
  o += a16(ls);
  L.idF = o;
  o += a16(4 * ls);
  L.idR = o;
  o += a16(4 * ls);
  if (subs) o += subs_bytes(Lp, sz);
  // temp region: R, Rr and the prefix rows (then the RBS window scores over
  // the rows); then the four (substitution mode: eight) class cumsums; then
  // the sort keys
  const size_t tmp = o;
  L.R = tmp;
  L.Rr = tmp + a16(sz * lp);
  L.rows = L.Rr + a16(sz * lp);
  L.pwF = L.rows;
  L.pwR = L.rows + a16(sz * lp);
  const size_t ph1 = 2 * a16(sz * lp) +
                     maxz(a16(sz * 3 * (size_t)L.rowlen), 2 * a16(sz * lp));
  L.F = tmp;
  L.keys = tmp;
  const size_t ph2 = (subs ? 8 : 4) * a16(4 * lp);
  const size_t ph3 = a16(8 * (subs ? 8 * lp + 33 : 4 * lp + 18));
  L.total = tmp + maxz(ph1, maxz(ph2, ph3));
  return L;
}

__device__ inline int pmod3(int x) {
  const int r = x % 3;
  return r < 0 ? r + 3 : r;
}
__device__ inline int fdiv3(int x) { return x >= 0 ? x / 3 : -((2 - x) / 3); }
__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ inline int topj(int mm) {
  const int t = fdiv3(mm - 1) * 3;
  return t < -3 ? -3 : t;
}
__device__ inline int vstop(int c) { return c == 0 ? -1 : (c == 1 ? 0 : -2); }

__device__ inline double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double lg(double x) { return log(x); }
__device__ inline float lg(float x) { return logf(x); }
template <typename S>
__device__ inline S clamp0(S x) {
  return x < (S)0 ? (S)0 : x;
}
template <typename S>
__device__ inline S neg_inf() {
  return -(S)INFINITY;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};
struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// Block scan of NL integer lanes (Hillis-Steele in shared memory): ex gets
// op over the threads before this one (after it with ``rev``), or id; tot
// op over all threads. Every thread of the block calls it.
template <int NL, class Op>
__device__ void block_scan(const int (&v)[NL], int (&ex)[NL], int (&tot)[NL],
                           bool rev, Op op, int id, int* buf) {
  const int me = rev ? T - 1 - (int)threadIdx.x : (int)threadIdx.x;
  int* a = buf;
  int* b = buf + T * NL;
  for (int l = 0; l < NL; ++l) a[me * NL + l] = v[l];
  __syncthreads();
  for (int d = 1; d < T; d <<= 1) {
    for (int l = 0; l < NL; ++l) {
      int x = a[me * NL + l];
      if (me >= d) x = op(a[(me - d) * NL + l], x);
      b[me * NL + l] = x;
    }
    __syncthreads();
    int* t = a;
    a = b;
    b = t;
  }
  for (int l = 0; l < NL; ++l) {
    ex[l] = me > 0 ? a[(me - 1) * NL + l] : id;
    tot[l] = a[(T - 1) * NL + l];
  }
  __syncthreads();
}

// The thread's codon columns [c0, c1) of ncol.
__device__ inline void my_cols(int ncol, int& c0, int& c1) {
  const int K = cdiv(ncol, T);
  c0 = min((int)threadIdx.x * K, ncol);
  c1 = min(c0 + K, ncol);
}

// Scan within each frame class i % 3 (forward, or from the end with rev):
// put(i, op over the class's get(i') for i' <= i, or i' >= i).
template <class Op, class Get, class Put>
__device__ void class_scan(int ncol, bool rev, Op op, int id, Get get, Put put,
                           int* buf) {
  int c0, c1;
  my_cols(ncol, c0, c1);
  int v[3], ex[3], tot[3];
  for (int k = 0; k < 3; ++k) {
    int a = id;
    if (!rev)
      for (int c = c0; c < c1; ++c) a = op(a, get(3 * c + k));
    else
      for (int c = c1 - 1; c >= c0; --c) a = op(a, get(3 * c + k));
    v[k] = a;
  }
  block_scan<3>(v, ex, tot, rev, op, id, buf);
  for (int k = 0; k < 3; ++k) {
    int a = ex[k];
    if (!rev)
      for (int c = c0; c < c1; ++c) {
        a = op(a, get(3 * c + k));
        put(3 * c + k, a);
      }
    else
      for (int c = c1 - 1; c >= c0; --c) {
        a = op(a, get(3 * c + k));
        put(3 * c + k, a);
      }
  }
  __syncthreads();
}

// One read's state: the workspace arrays and the group's tables.
template <typename S>
struct Rd {
  uint8_t* fl;
  int *psf, *nsf, *psr, *nsr, *nstf, *pstr;
  S *scoreF, *scoreR;
  uint8_t *cfF, *cfR, *evF, *evR;
  int *idF, *idR;
  S *R, *Rr, *rows, *pwF, *pwR;
  int* F;
  long long* keys;
  int Lp, n, mgl, min_j, isl, LN, nm, W, rbw;
  bool is_user, any_mode;
  int npc[3], rnc[3];
  S prior, ev, th;
  const double* len;   // (3, LN)
  const float* slo;    // (NS,)
};

// The substitution mode's further state of a read.
template <typename S>
struct RdS : Rd<S> {
  S *scoreSF, *scoreSR;  // sub std scores
  uint8_t *cfSF, *cfSR;  // their RAWOK / PASS / FINAL bits
  int *idSF, *idSR;      // sub ids of the slots
  const int* seq;        // (Lp,) the read
  const uint8_t* q;      // (Lp,) its qualities, or null
  const double* cp;      // _CP_TAB
  S pen[4];              // the no-quality penalties in the carry's type
  S two3, one3;
  int lowest_j;
};

// fwd_prev: the Save_Prev_Stops register (max of the class's initial value
// and the previous fwd stop).
template <typename S>
__device__ inline int fwd_prev(const Rd<S>& r, int x) {
  const int c = x % 3;
  const int init = c == 0 ? 0 : (c == 1 ? 1 : -1);
  const int p = r.psf[x];
  return init > p ? init : p;
}

template <typename S>
__device__ inline int rev_next(const Rd<S>& r, int x) {
  const int fr = pmod3(r.n - 1 - x);
  const int init = fr == 0 ? r.n - 1 : (fr == 1 ? r.n - 2 : r.n);
  const int cand = (x + 2 < r.Lp && r.nsr[x + 2] < BIG) ? r.nsr[x + 2] - 2
                                                         : BIG;
  return init < cand ? init : cand;
}

// first fwd start after the previous stop, read at position i (ssp)
template <typename S>
__device__ inline int ssp(const Rd<S>& r, int i) {
  const int p = r.psf[i];
  if (p <= -HALF) return BIG;
  return p + 3 < r.Lp ? r.nstf[p + 3] : BIG;
}

// rev_next[prev rev stop + 1], read at position i (ffn)
template <typename S>
__device__ inline int ffn(const Rd<S>& r, int i) {
  const int p = r.psr[i];
  if (p <= -HALF) return 0;
  return p + 1 < r.Lp ? rev_next(r, p + 1) : 0;
}

struct Slot {
  int iS, lo, hi, mm, top;
  bool emit, trunc, t3;
};

// Forward-ORF slot s in [0, Lp + 3) (_fwd_orf_slots, indel_orfs=SUBS).
template <bool SUBS, typename S>
__device__ Slot fwd_slot(const Rd<S>& r, int s) {
  const int Lp = r.Lp, n = r.n;
  Slot o;
  int ip, ssprev, ssnp;
  bool exists;
  if (s < Lp) {
    o.iS = s;
    ip = s >= 3 ? r.psf[s - 3] : -BIG;
    ssprev = s >= 3 ? ssp(r, s - 3) : BIG;
    ssnp = r.npc[s % 3];
    exists = r.fl[s] & FT;
    o.lo = (s >= 3 ? fwd_prev(r, s - 3) : s - 3) + 1;
    o.t3 = s >= n;
  } else {
    const int k = s - Lp;
    o.iS = n + k;
    const int cv = pmod3(n + k);
    ip = r.psf[Lp - 3 + cv];
    ssprev = ssp(r, Lp - 3 + cv);
    ssnp = r.npc[cv];
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
template <bool SUBS, typename S>
__device__ Slot rev_slot(const Rd<S>& r, int s) {
  const int Lp = r.Lp, n = r.n;
  Slot o;
  int c, ip, ls, ffv;
  bool exists, virt = s >= Lp;
  if (!virt) {
    c = s % 3;
    ip = s >= 3 ? r.psr[s - 3] : -BIG;
    ls = s >= 3 ? r.pstr[s - 3] : -BIG;
    exists = r.fl[s] & RT;
    ffv = s >= 3 ? ffn(r, s - 3) : 0;
  } else {
    c = s - Lp;
    ip = r.psr[Lp - 3 + c];
    ls = (n - 3 >= 0 && n - 3 < Lp) ? r.pstr[n - 3] : -BIG;
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
  const int rnv = hp ? ffv : r.rnc[c];
  o.hi = ((x_ep >= 0 && x_ep < n) ? rnv : x_ep) + 1;
  o.lo = orf_stop + 3;
  o.mm = o.hi - o.lo;
  o.top = topj(o.mm);
  o.trunc = (n - (o.hi - 1)) < 3;
  o.t3 = orf_stop < 1;
  return o;
}

// the closing slot of a member (prop's revfill, else the virtual tail)
template <typename S>
__device__ inline int slot_mf(const Rd<S>& r, int q) {
  const int nx = q + 5 < r.Lp ? r.nsf[q + 5] : BIG;
  return nx < BIG ? nx : r.Lp + pmod3(q + 2 - r.n);
}
template <typename S>
__device__ inline int slot_mr(const Rd<S>& r, int u) {
  const int nx = u + 3 < r.Lp ? r.nsr[u + 3] : BIG;
  return nx < HALF ? nx : r.Lp + u % 3;
}

// ---- substitution mode: the next / previous slot reads ----

// The forward slot after position x in its frame (nxt's slot): the next
// stop of x's class past x, else the virtual slot of x's class.
template <typename S>
__device__ inline int next_f(const Rd<S>& r, int x) {
  const int nx = x + 3 < r.Lp ? r.nsf[x + 3] : BIG;
  return nx < BIG ? nx : r.Lp + pmod3(x - r.n);
}
// mm2: the suffix length at a forward stop x (to the next slot's stop).
template <typename S>
__device__ inline int mm2_f(const Rd<S>& r, int x) {
  const int nx = x + 3 < r.Lp ? r.nsf[x + 3] : BIG;
  return (nx < BIG ? nx : r.n + pmod3(x - r.n)) - x - 3;
}
// A_ext at a forward slot: the class diagonal at hi(s) - 1.
template <typename S>
__device__ inline S a_slot(const Rd<S>& r, int s) {
  if (s < r.Lp) return s >= 3 ? r.R[s - 3] : (S)0;
  const int xv = r.n + (s - r.Lp) - 3;
  return (xv >= 0 && xv < r.Lp) ? r.R[xv] : (S)0;
}
// The previous forward stop of slot s (the ORF's ip), or -BIG.
template <typename S>
__device__ inline int prev_f(const Rd<S>& r, int s) {
  if (s < r.Lp) return s >= 3 ? r.psf[s - 3] : -BIG;
  return r.psf[r.Lp - 3 + pmod3(r.n + s - r.Lp)];
}
// The tie key of a slot's events (4 x the slot's rank key of _assign_ids).
template <typename S>
__device__ inline int k4_f(const Rd<S>& r, int s) {
  return 4 * (s < r.Lp ? 2 * s + 1 : 2 * r.Lp + 8 + (s - r.Lp));
}
template <typename S>
__device__ inline int k4_r(const Rd<S>& r, int s) {
  return 4 * (s < r.Lp ? 2 * s : 2 * r.Lp + 4 + (s - r.Lp));
}

__device__ inline double pp_lo(double) { return 0x1p-1022; }
__device__ inline float pp_lo(float) { return 0x1p-126f; }
__device__ inline double pp_hi(double) { return 1.0 - 0x1p-53; }
__device__ inline float pp_hi(float) { return 1.0f - 0x1p-24f; }

// Pass_Stop_Penalty of a stop codon read through as a substitution, whose
// last base (in the read) is x (_stop_penalty). mid / last: the codon's
// middle / last base in the gene's direction is the one the reference
// weighs up.
template <typename S>
__device__ S stop_pen(const RdS<S>& r, int x, bool mid, bool last, bool fwd) {
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
template <typename S>
__device__ S suf_f(const RdS<S>& r, int x) {
  const bool mid = x >= 1 && r.seq[x - 1] == 0, last = r.seq[x] == 0;
  return stop_pen(r, x, mid, last, true) + (a_slot(r, next_f(r, x)) - r.R[x]);
}
// suf_pos at a reverse stop x: the penalty plus the segment of the ORF it
// closes.
template <typename S>
__device__ S suf_r(const RdS<S>& r, int x) {
  const S a = x >= 3 ? r.Rr[x - 3] : (S)0;
  S b = (S)0;
  if (x >= 3) {
    const int y = x - 3, p = r.psr[y], c = y % 3;
    b = p > -HALF ? r.Rr[p] : (c == 0 ? r.Rr[0] : (c == 1 ? r.Rr[1] : (S)0));
  }
  const bool mid = x >= 1 && r.seq[x - 1] == 3;
  const bool last = x >= 2 && r.seq[x - 2] == 3;
  return stop_pen(r, x, mid, last, false) + (a - b);
}

// Best RBS window of a start at 0-based p (_pwm_window_tables + fix).
template <typename S>
__device__ void best_f(const Rd<S>& r, int p, S& best, int& sep) {
  best = neg_inf<S>();
  sep = 0;
  if (r.any_mode)
    for (int s = 0; s <= r.rbw - r.W; ++s)
      if (p - r.W - s >= 0) {
        const S v = r.pwF[p - r.W - s];
        if (v > best) {
          best = v;
          sep = s;
        }
      }
  if (!isfinite(best)) {
    if (r.is_user) best = (S)0;
    sep = 0;
  }
}
template <typename S>
__device__ void best_r(const Rd<S>& r, int p, S& best, int& sep) {
  best = neg_inf<S>();
  sep = 0;
  if (r.any_mode)
    for (int s = 0; s <= r.rbw - r.W; ++s)
      if (p + r.W + s < r.n) {
        const S v = p + s + 1 < r.Lp ? r.pwR[p + s + 1] : neg_inf<S>();
        if (v > best) {
          best = v;
          sep = s;
        }
      }
  if (!isfinite(best)) {
    if (r.is_user) best = (S)0;
    sep = 0;
  }
}

// Add_Events' separation-weighted RBS boost (_add_pwm).
template <typename S>
__device__ inline S add_pwm(S score, S pwm, int sep) {
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
template <typename S, bool RBS>
__device__ inline S score_tail(const Rd<S>& r, S raw, S pwm, int sep, int row,
                               int idx, int wcode) {
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

template <typename S>
__device__ Item<S> item(const Rd<S>& r, const Tr<S>& tr, int idx) {
  const int Lp = r.Lp;
  Item<S> it;
  it.trunc = false;
  it.score = (S)0;
  if (idx < Lp) {  // std_f
    const int q = idx, sl = slot_mf(r, q);
    it.valid = (r.cfF[q] & FINAL) && r.evF[sl];
    it.pos = q + 3;
    it.typ = E_FWD_START;
    it.sub = q % 3;
    it.id = r.idF[sl];
    it.score = r.scoreF[q];
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_f
    it.valid = tr.fin[idx] && r.evF[tr.slotc[idx]];
    it.pos = tr.pos[idx];
    it.typ = E_FWD_START;
    it.sub = tr.sub[idx];
    it.id = r.idF[tr.slotc[idx]];
    it.score = tr.score[idx];
    it.trunc = true;
    return it;
  }
  idx -= 6;
  if (idx < Lp + 3) {  // stop_f
    const int s = idx, iS = s < Lp ? s : r.n + s - Lp;
    it.valid = r.evF[s];
    it.pos = iS + 1;
    it.typ = E_FWD_STOP;
    it.sub = (pmod3(iS) + 1) % 3;
    it.id = r.idF[s];
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp) {  // std_r
    const int u = idx, sl = slot_mr(r, u);
    it.valid = (r.cfR[u] & FINAL) && r.evR[sl];
    it.pos = u + 1;
    it.typ = E_REV_START;
    it.sub = 3 + (u % 3 + 1) % 3;
    it.id = r.idR[sl];
    it.score = r.scoreR[u];
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_r
    const int k = 6 + idx;
    it.valid = tr.fin[k] && r.evR[tr.slotc[k]];
    it.pos = tr.pos[k];
    it.typ = E_REV_START;
    it.sub = tr.sub[k];
    it.id = r.idR[tr.slotc[k]];
    it.score = tr.score[k];
    it.trunc = true;
    return it;
  }
  idx -= 6;  // stop_r
  const int s = idx;
  int ip, c;
  if (s < Lp) {
    c = s % 3;
    ip = s >= 3 ? r.psr[s - 3] : -BIG;
  } else {
    c = s - Lp;
    ip = r.psr[Lp - 3 + c];
  }
  const int orf_stop = ip > -HALF ? ip - 1 : vstop(c);
  it.valid = r.evR[s];
  it.pos = orf_stop + 2;
  it.typ = E_REV_STOP;
  it.sub = 3 + (c + 1) % 3;
  it.id = r.idR[s];
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
template <typename S>
__device__ ItemS<S> item_s(const RdS<S>& r, const TrS<S>& tr, int idx) {
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
    clean(idx, k4_f(r, slot_mf(r, idx)) + 1);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_f
    clean(Lp + idx, k4_f(r, tr.slotc[idx]) + 1);
    return it;
  }
  idx -= 6;
  if (idx < Lp) {  // sub_std_f: ids and gates of the slot after the stop
    const int q = idx;
    const int s1 = q + 5 < Lp ? r.nsf[q + 5] : BIG;
    const bool has = s1 < BIG;
    const int s2 = has ? next_f(r, s1) : 0;
    const int ivirt = r.n + pmod3(q + 2 - r.n);
    sub_ev(q + 3, E_FWD_START, q % 3, has ? r.idSF[s2] : 0, r.scoreSF[q],
           false, (r.cfSF[q] & FINAL) && has && (r.evF[s2] & EVP),
           (s1 < ivirt ? s1 : ivirt) - 1, (has ? k4_f(r, s2) : 0) + 1);
    return it;
  }
  idx -= Lp;
  if (idx < 3) {  // sub_tr_f
    const int s2 = tr.s2[idx];
    sub_ev(tr.pos[idx], E_FWD_START, tr.sub[idx], r.idSF[s2],
           tr.sscore[idx], true,
           tr.sfin[idx] && tr.ok[idx] && (r.evF[s2] & EVP), tr.epos[idx],
           k4_f(r, s2) + 1);
    return it;
  }
  idx -= 3;
  if (idx < Lp + 3) {  // stop_f
    clean(Lp + 6 + idx, k4_f(r, idx) + 2);
    it.valid = (r.evF[idx] & CLN) != 0;
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp + 3) {  // sub_stop_f: the error is at the ORF's previous stop
    const int s = idx, ip = prev_f(r, s);
    sub_stop(Lp + 6 + s, k4_f(r, s) + 3, (r.evF[s] & SUBB) != 0, r.idSF[s],
             (ip > -HALF ? ip : 0) - 1);
    return it;
  }
  idx -= Lp + 3;
  if (idx < Lp) {  // sub_std_r: ids and gates of the ORF before u's
    const int u = idx, p = r.psr[u];
    const bool hp = p > -HALF;
    sub_ev(u + 1, E_REV_START, 3 + (u % 3 + 1) % 3, hp ? r.idSR[p] : 0,
           r.scoreSR[u], false, (r.cfSR[u] & FINAL) && hp && (r.evR[p] & EVP),
           p + 1, (hp ? k4_r(r, p) : 0) + 2);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // sub_tr_r
    const int e = 3 + idx, s2 = tr.s2[e];
    sub_ev(tr.pos[6 + idx], E_REV_START, tr.sub[6 + idx], r.idSR[s2],
           tr.sscore[e], true, tr.sfin[e] && tr.ok[e] && (r.evR[s2] & EVP),
           tr.epos[e], k4_r(r, s2) + 2);
    return it;
  }
  idx -= 6;
  if (idx < Lp) {  // std_r
    clean(EF + idx, k4_r(r, slot_mr(r, idx)) + 2);
    return it;
  }
  idx -= Lp;
  if (idx < 6) {  // tr_r
    clean(EF + Lp + idx, k4_r(r, tr.slotc[6 + idx]) + 2);
    return it;
  }
  idx -= 6;
  if (idx < Lp + 3) {  // stop_r
    clean(EF + Lp + 6 + idx, k4_r(r, idx));
    it.valid = (r.evR[idx] & CLN) != 0;
    return it;
  }
  idx -= Lp + 3;  // sub_stop_r: the error is at the closing stop
  sub_stop(EF + Lp + 6 + idx, k4_r(r, idx) + 1, (r.evR[idx] & SUBB) != 0,
           r.idSR[idx], idx + 1);
  return it;
}

// Sorts keys[0, nv) ascending in place: a bitonic network (all comparators
// ascending, the first step of each merge reflected), in which entries past
// nv act as +inf and never move. Every thread of the block calls it.
__device__ __forceinline__ void sort_keys(long long* keys, int nv) {
  for (int k = 2; k < 2 * nv; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < nv; i += T) {
        const int p = j == (k >> 1) ? (i ^ (k - 1)) : (i ^ j);
        if (p > i && p < nv) {
          const long long x = keys[i], y = keys[p];
          if (y < x) {
            keys[i] = y;
            keys[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// A forward seg_exists at slot x: some candidate of the ORF's run in F.
template <typename S>
__device__ inline bool seg_f(const Rd<S>& r, const int* F, int x) {
  const int Lp = r.Lp;
  auto fh = [&](int y) { return y >= 5 ? F[y - 5] : 0; };
  auto ffz = [&](int y) {
    const int p = r.psf[y];
    return p > -HALF ? fh(p) : 0;
  };
  if (x < Lp) return fh(x) - (x >= 3 ? ffz(x - 3) : 0) > 0;
  const int k = x - Lp;
  return F[Lp - 3 + pmod3(r.n + k + 1)] - ffz(Lp - 3 + pmod3(r.n + k)) > 0;
}
template <typename S>
__device__ inline bool seg_r(const Rd<S>& r, const int* F, int x) {
  const int Lp = r.Lp;
  auto fh = [&](int y) { return y >= 3 ? F[y - 3] : 0; };
  auto ffz = [&](int y) {
    const int p = r.psr[y];
    return p > -HALF ? fh(p) : 0;
  };
  if (x < Lp) return fh(x) - (x >= 3 ? ffz(x - 3) : 0) > 0;
  const int k = x - Lp;
  return F[Lp - 3 + k] - ffz(Lp - 3 + k) > 0;
}

// The three rows of one strand's _frame_prefix_sums in _blocked_cumsum's
// order; writes the class diagonal out[x] = S[x % 3][x].
template <typename S>
__device__ void prefix_diag(const Args& a, const Layout& L, const Rd<S>& r,
                            int b, bool fwd, S* out) {
  const int Lp = r.Lp, n = r.n, P = pad16(Lp), rl = L.rowlen;
  S* rows = r.rows;
  const float* g = a.gene6 + (size_t)b * 6 * Lp;
  const float* h = a.ind6 + (size_t)b * 6 * Lp;
  for (int i = threadIdx.x; i < 3 * P; i += T) {
    const int c = i / P, p = i % P;
    S v = (S)0;
    if (p < Lp && p < n) {
      if (fwd) {
        const int rr = pmod3(c + 1 - p);
        const int ridx = min(max(n - 1 - p, 0), Lp - 1);
        v = (S)g[rr * Lp + ridx] - (S)h[rr * Lp + ridx];
      } else {
        const int rr = pmod3(p - c);
        v = (S)g[(3 + rr) * Lp + p] - (S)h[(3 + rr) * Lp + p];
      }
    }
    rows[c * rl + p] = v;
  }
  __syncthreads();
  // blocked levels: inner sequential scans, totals into the next level
  for (int l = 0; l + 1 < L.nlev; ++l) {
    const int nb = L.lev_n[l + 1], pn = pad16(nb);
    for (int i = threadIdx.x; i < 3 * pn; i += T) {
      const int c = i / pn, blk = i % pn;
      S* up = rows + c * rl + L.lev_off[l + 1];
      if (blk >= nb) {
        up[blk] = (S)0;
        continue;
      }
      S* x = rows + c * rl + L.lev_off[l] + blk * 16;
      S acc = x[0];
      for (int k = 1; k < 16; ++k) {
        acc = acc + x[k];
        x[k] = acc;
      }
      up[blk] = acc;
    }
    __syncthreads();
  }
  // the last level: one sequential scan a row
  {
    const int lt = L.nlev - 1, m = L.lev_n[lt];
    if ((int)threadIdx.x < 3) {
      S* x = rows + threadIdx.x * rl + L.lev_off[lt];
      S acc = x[0];
      for (int k = 1; k < m; ++k) {
        acc = acc + x[k];
        x[k] = acc;
      }
    }
    __syncthreads();
  }
  // back down: level l += exclusive totals of level l + 1
  for (int l = L.nlev - 2; l >= 1; --l) {
    const int m = L.lev_n[l];
    for (int i = threadIdx.x; i < 3 * m; i += T) {
      const int c = i / m, k = i % m;
      S* x = rows + c * rl + L.lev_off[l];
      const S* up = rows + c * rl + L.lev_off[l + 1];
      x[k] = x[k] + (k / 16 == 0 ? (S)0 : up[k / 16 - 1]);
    }
    __syncthreads();
  }
  for (int x = threadIdx.x; x < Lp; x += T) {
    const int c = x % 3;
    const S* row = rows + c * rl;
    out[x] = row[x] + (x / 16 == 0 ? (S)0 : row[L.lev_off[1] + x / 16 - 1]);
  }
  __syncthreads();
}

template <typename S, bool RBS, bool SUBS>
__global__ void __launch_bounds__(T)
    frontend_kernel(typename std::conditional<SUBS, ArgsS, Args>::type a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int sbuf[2 * T * 3];
  __shared__ typename std::conditional<SUBS, TrS<S>, Tr<S>>::type tr;

  const int Lp = a.Lp, ncol = Lp / 3, N = SUBS ? 8 * Lp + 33 : 4 * Lp + 18;
  const int Eo = a.E < N ? a.E : N;
  const Layout L = make_layout(Lp, (int)sizeof(S), SUBS);
  unsigned char* ws =
      a.scratch ? a.scratch + (size_t)blockIdx.x * (size_t)a.ws_bytes : dsm;
  const int tid = threadIdx.x;

  typename std::conditional<SUBS, RdS<S>, Rd<S>>::type r;
  r.fl = ws + L.fl;
  r.psf = (int*)(ws + L.psf);
  r.nsf = (int*)(ws + L.nsf);
  r.psr = (int*)(ws + L.psr);
  r.nsr = (int*)(ws + L.nsr);
  r.nstf = (int*)(ws + L.nstf);
  r.pstr = (int*)(ws + L.pstr);
  r.scoreF = (S*)(ws + L.scoreF);
  r.scoreR = (S*)(ws + L.scoreR);
  r.cfF = ws + L.cfF;
  r.cfR = ws + L.cfR;
  r.evF = ws + L.evF;
  r.evR = ws + L.evR;
  r.idF = (int*)(ws + L.idF);
  r.idR = (int*)(ws + L.idR);
  r.R = (S*)(ws + L.R);
  r.Rr = (S*)(ws + L.Rr);
  r.rows = (S*)(ws + L.rows);
  r.pwF = (S*)(ws + L.pwF);
  r.pwR = (S*)(ws + L.pwR);
  r.F = (int*)(ws + L.F);
  r.keys = (long long*)(ws + L.keys);
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
    const size_t lp = (size_t)Lp, sz = sizeof(S), o = L.idR + a16(4 * (lp + 3));
    r.scoreSF = (S*)(ws + o);
    r.scoreSR = (S*)(ws + o + a16(sz * lp));
    r.cfSF = ws + o + 2 * a16(sz * lp);
    r.cfSR = ws + o + 2 * a16(sz * lp) + a16(lp);
    r.idSF = (int*)(ws + o + 2 * a16(sz * lp) + 2 * a16(lp));
    r.idSR = (int*)(ws + o + 2 * a16(sz * lp) + 2 * a16(lp) + a16(4 * (lp + 3)));
    r.cp = a.cp;
    for (int k = 0; k < 4; ++k) r.pen[k] = (S)a.pen[k];
    r.two3 = (S)(2.0 / 3.0);
    r.one3 = (S)(1.0 / 3.0);
    const int m3 = a.mgl - 3;
    r.lowest_j = 3 < m3 ? 3 : m3;
  }

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

    // ---- codon flags (_read_tables) ----
    for (int i = tid; i < Lp; i += T) {
      int cod = 64;
      if (i >= 2 && i < n) cod = seq[i - 2] * 16 + seq[i - 1] * 4 + seq[i];
      cod = clampi(cod, 0, 64);
      const int o = gi * 65 + cod;
      const int wf = a.which_fwd[o], wr = a.which_rev[o];
      r.fl[i] = (uint8_t)((a.fwd_start[o] ? FS : 0) |
                          (a.rev_start[o] ? RS : 0) |
                          (a.fwd_stop[o] ? FT : 0) | (a.rev_stop[o] ? RT : 0) |
                          ((wf < 0 ? NONE : (wf > 2 ? 2 : wf)) << 4) |
                          ((wr < 0 ? NONE : (wr > 2 ? 2 : wr)) << 6));
    }
    __syncthreads();

    // ---- the six frame-class scans ----
    {
      uint8_t* fl = r.fl;
      auto at = [fl](int bit, int fill) {
        return [fl, bit, fill](int i) { return (fl[i] & bit) ? i : fill; };
      };
      auto to = [](int* dst) { return [dst](int i, int v) { dst[i] = v; }; };
      class_scan(ncol, false, MaxOp(), -BIG, at(FT, -BIG), to(r.psf), sbuf);
      class_scan(ncol, true, MinOp(), BIG, at(FT, BIG), to(r.nsf), sbuf);
      class_scan(ncol, false, MaxOp(), -BIG, at(RT, -BIG), to(r.psr), sbuf);
      class_scan(ncol, true, MinOp(), BIG, at(RT, BIG), to(r.nsr), sbuf);
      class_scan(ncol, true, MinOp(), BIG, at(FS, BIG), to(r.nstf), sbuf);
      class_scan(ncol, false, MaxOp(), -BIG, at(RS, -BIG), to(r.pstr), sbuf);
    }
    r.npc[0] = r.nstf[3];
    r.npc[1] = r.nstf[4];
    r.npc[2] = r.nstf[2];
    r.rnc[0] = rev_next(r, 1);
    r.rnc[1] = rev_next(r, 2);
    r.rnc[2] = rev_next(r, 0);

    // ---- per-frame LLR prefix sums: the class diagonals ----
    prefix_diag(a, L, r, b, true, r.R);
    prefix_diag(a, L, r, b, false, r.Rr);

    // ---- RBS window scores (_pwm_arrays) ----
    if (RBS) {
      const int C = a.C, WT = a.WT, W = a.W;
      const double* cols = a.pwm_cols + (size_t)gi * C * WT * 4;
      const double* ucols = a.pwm_user + (size_t)gi * WT * 4;
      const double* gcl = a.gc_lp + (size_t)gi * 4;
      const S denom = (S)(r.nm > 1 ? r.nm : 1);
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
        r.pwF[p] = scf;
        r.pwR[p] = scr;
      }
      __syncthreads();
    }

    // ---- std start candidates, both strands ----
    for (int q = tid; q < Lp; q += T) {
      // forward: q is the start codon's first base
      {
        const int i_next = q + 5 < Lp ? r.nsf[q + 5] : BIG;
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
        const bool hit2 = q + 2 < Lp && (r.fl[q + 2] & FS);
        const int wc = q + 2 < Lp ? (r.fl[q + 2] >> 4) & 3 : NONE;
        const bool valid = emit && q >= lo && j >= r.min_j && j <= top && hit2;
        S av;
        if (sl < Lp) {
          av = sl >= 3 ? r.R[sl - 3] : (S)0;
        } else {
          const int xv = n + (sl - Lp) - 3;
          av = (xv >= 0 && xv < Lp) ? r.R[xv] : (S)0;
        }
        const S raw_nb = av - (q + 2 < Lp ? r.R[q + 2] : (S)0);
        const S raw = j + 2 > r.isl ? clamp0(raw_nb) : raw_nb;
        S pwm = (S)0;
        int sep = 0;
        if (RBS) best_f(r, q, pwm, sep);
        const S score = score_tail<S, RBS>(r, raw, pwm, sep, is_real ? 0 : 1,
                                           clampi(fdiv3(j) + 1, 0, r.LN - 1),
                                           wc);
        r.scoreF[q] = score;
        r.cfF[q] = (uint8_t)((valid && raw > r.th ? RAWOK : 0) |
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
          const bool sv = is_real && em2 && q >= lo && j >= mjs && j <= top &&
                          hit2 && 1 + jf >= r.mgl;
          S rt = raw_nb + suf;
          if (jf > r.isl) rt = clamp0(rt);
          const S ss = score_tail<S, RBS>(
              r, rt, pwm, sep, t32 ? 1 : 0,
              clampi(fdiv3(j + sj) + 1, 0, r.LN - 1), wc);
          r.scoreSF[q] = ss;
          r.cfSF[q] = (uint8_t)((sv && rt > r.th ? RAWOK : 0) |
                                (sv && ss > r.ev ? PASS : 0));
        }
      }
      // reverse: u = q is the start codon's last base
      {
        const int u = q, c = u % 3;
        const int i_close = u + 3 < Lp ? r.nsr[u + 3] : BIG;
        const bool is_real = i_close < HALF;
        const int sl = is_real ? i_close : Lp + c;
        const bool emit = rev_slot<SUBS>(r, sl).emit;
        const int ip = r.psr[u];
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
        const bool valid = emit && (r.fl[u] & RS) && j >= r.min_j &&
                           j <= top && u <= hi - 2;
        const int wc = (r.fl[u] >> 6) & 3;
        const S av = u >= 3 ? r.Rr[u - 3] : (S)0;
        const S bv = hp ? r.Rr[ip] : (c == 0 ? r.Rr[0] : (c == 1 ? r.Rr[1]
                                                                  : (S)0));
        const S raw_nb = av - bv;
        const S raw = j + 2 > r.isl ? clamp0(raw_nb) : raw_nb;
        S pwm = (S)0;
        int sep = 0;
        if (RBS) best_r(r, u, pwm, sep);
        const S score = score_tail<S, RBS>(r, raw, pwm, sep,
                                           orf_stop < 1 ? 1 : 0,
                                           clampi(fdiv3(j) + 1, 0, r.LN - 1),
                                           wc);
        r.scoreR[u] = score;
        r.cfR[u] = (uint8_t)((valid && raw > r.th ? RAWOK : 0) |
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
          const bool sv = hp && em2 && (r.fl[u] & RS) && j >= mjs &&
                          j <= top && u <= hi - 2 && 1 + jf >= r.mgl;
          S rt = raw_nb + suf;
          if (jf > r.isl) rt = clamp0(rt);
          const S ss = score_tail<S, RBS>(
              r, rt, pwm, sep, t32 ? 1 : 0,
              clampi(fdiv3(j + sj) + 1, 0, r.LN - 1), wc);
          r.scoreSR[u] = ss;
          r.cfSR[u] = (uint8_t)((sv && rt > r.th ? RAWOK : 0) |
                                (sv && ss > r.ev ? PASS : 0));
        }
      }
    }
    __syncthreads();

    // ---- truncated first/last starts: 6 a strand ----
    if (tid < 12) {
      const bool fwd = tid < 6;
      const int k = fwd ? tid : tid - 6;
      int slot6;
      bool v6;
      if (k < 3) {
        if (fwd) {
          const int fs = r.nsf[k];
          v6 = fs < HALF;
          slot6 = v6 ? fs : -1;
        } else {
          const int ls = r.psr[Lp - 3 + k];
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
      const S* D = fwd ? r.R : r.Rr;
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
      const uint8_t* cf = fwd ? r.cfF : r.cfR;
      const S* scs = fwd ? r.scoreF : r.scoreR;
      const bool std_at = inr && (cf[qt] & PASS);
      const S ss = inr ? scs[qt] : neg_inf<S>();
      tr.slot[tid] = slot6;
      tr.slotc[tid] = sc;
      tr.q[tid] = qt;
      tr.pos[tid] = pos;
      tr.sub[tid] = sub;
      tr.fin[tid] = tp && !(std_at && ss > st);
      tr.kill[tid] = tp && (ss <= st);
      tr.raw[tid] = tv && raw > r.th;
      tr.score[tid] = st;
      if constexpr (SUBS) {
        // the truncated sub entries: forward the first ORF of each class
        // chain extended into its next slot (s2slot6); reverse each
        // truncated ORF extended from its previous slot
        if (!fwd || k < 3) {
          const int e = fwd ? k : 3 + k;
          int s2, sj, epos;
          bool ok, em2, t32;
          S suf;
          if (fwd) {
            const int fs = r.nsf[k] < Lp - 1 ? r.nsf[k] : Lp - 1;
            s2 = next_f(r, fs);
            ok = v6;
            sj = mm2_f(r, fs);
            em2 = fwd_slot<true>(r, s2).emit;
            t32 = s2 >= Lp;
            suf = suf_f(r, fs);
            epos = v6 ? r.nsf[k] - 1 : -1;
          } else {
            const int ls = r.psr[Lp - 3 + (k < 3 ? k : k - 3)];
            if (k < 3) {
              const int x = clampi(ls, 0, Lp - 1) - 3;
              const int pp3 = x >= 0 ? r.psr[x] : -BIG;
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
          const uint8_t* scf = fwd ? r.cfSF : r.cfSR;
          const S* sss = fwd ? r.scoreSF : r.scoreSR;
          const bool sat = inr && (scf[qt] & PASS);
          const S ssc = inr ? sss[qt] : neg_inf<S>();
          tr.s2[e] = s2;
          tr.epos[e] = epos;
          tr.ok[e] = ok;
          tr.sfin[e] = sp && !(sat && ssc > s6);
          tr.skill[e] = sp && (ssc <= s6);
          tr.sraw[e] = sv && r6 > r.th;
          tr.sscore[e] = s6;
        }
      }
    }
    __syncthreads();

    // ---- _dedup: std entries a truncated entry kills ----
    for (int q = tid; q < Lp; q += T) {
      bool kf = false, kr = false;
      for (int k = 0; k < 6; ++k) {
        kf = kf || (q == tr.q[k] && tr.kill[k]);
        kr = kr || (q == tr.q[6 + k] && tr.kill[6 + k]);
      }
      if ((r.cfF[q] & PASS) && !kf) r.cfF[q] |= FINAL;
      if ((r.cfR[q] & PASS) && !kr) r.cfR[q] |= FINAL;
      if constexpr (SUBS) {
        bool sf = false, sr = false;
        for (int k = 0; k < 3; ++k) sf = sf || (q == tr.q[k] && tr.skill[k]);
        for (int k = 0; k < 6; ++k)
          sr = sr || (q == tr.q[6 + k] && tr.skill[3 + k]);
        if ((r.cfSF[q] & PASS) && !sf) r.cfSF[q] |= FINAL;
        if ((r.cfSR[q] & PASS) && !sr) r.cfSR[q] |= FINAL;
      }
    }
    __syncthreads();

    // ---- per-ORF aggregates: class cumsums of the indicators ----
    {
      int* F = r.F;
      uint8_t *cfF = r.cfF, *cfR = r.cfR;
      auto ind = [](const uint8_t* cf, uint8_t bit) {
        return [cf, bit](int i) { return (cf[i] & bit) ? 1 : 0; };
      };
      auto to = [](int* dst) { return [dst](int i, int v) { dst[i] = v; }; };
      class_scan(ncol, false, AddOp(), 0, ind(cfF, RAWOK), to(F), sbuf);
      class_scan(ncol, false, AddOp(), 0, ind(cfF, FINAL), to(F + Lp), sbuf);
      class_scan(ncol, false, AddOp(), 0, ind(cfR, RAWOK), to(F + 2 * Lp),
                 sbuf);
      class_scan(ncol, false, AddOp(), 0, ind(cfR, FINAL), to(F + 3 * Lp),
                 sbuf);
      if constexpr (SUBS) {
        uint8_t *sf = r.cfSF, *sr = r.cfSR;
        class_scan(ncol, false, AddOp(), 0, ind(sf, RAWOK), to(F + 4 * Lp),
                   sbuf);
        class_scan(ncol, false, AddOp(), 0, ind(sf, FINAL), to(F + 5 * Lp),
                   sbuf);
        class_scan(ncol, false, AddOp(), 0, ind(sr, RAWOK), to(F + 6 * Lp),
                   sbuf);
        class_scan(ncol, false, AddOp(), 0, ind(sr, FINAL), to(F + 7 * Lp),
                   sbuf);
      }
    }

    if constexpr (SUBS) {
      // ---- the per-slot event gates: evprod, and its clean and sub stop
      // events; a slot's sub set is counted over the run it extends into
      // (forward: its previous stop's run; reverse: the next slot's) ----
      for (int x = tid; x < Lp + 3; x += T) {
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
        const bool exf = (ip > -HALF && seg_f(r, r.F + 4 * Lp, ip)) || fs6;
        const bool anf = (ip > -HALF && seg_f(r, r.F + 5 * Lp, ip)) || fsa6;
        const bool clf = seg_f(r, r.F + Lp, x) || fa6;
        const bool ef = fwd_slot<true>(r, x).emit &&
                        (seg_f(r, r.F, x) || fr6 || exf) && (clf || anf);
        const int nx = x < Lp ? slot_mr(r, x) : -1;
        const bool exr = (nx >= 0 && seg_r(r, r.F + 6 * Lp, nx)) || rs6;
        const bool anr = (nx >= 0 && seg_r(r, r.F + 7 * Lp, nx)) || rsa6;
        const bool clr = seg_r(r, r.F + 3 * Lp, x) || ra6;
        const bool er = rev_slot<true>(r, x).emit &&
                        (seg_r(r, r.F + 2 * Lp, x) || rr6 || exr) &&
                        (clr || anr);
        r.evF[x] = (uint8_t)((ef ? EVP : 0) | (ef && clf ? CLN : 0) |
                             (ef && anf ? SUBB : 0));
        r.evR[x] = (uint8_t)((er ? EVP : 0) | (er && clr ? CLN : 0) |
                             (er && anr ? SUBB : 0));
      }
      __syncthreads();

      // ---- ids: ranks in the order, for s ascending, rev clean, rev sub,
      // fwd sub, fwd clean; then the rev end slots (clean, sub each), then
      // the fwd end slots (sub, clean each) ----
      {
        auto bit = [](const uint8_t* ev, int s, uint8_t m) {
          return (ev[s] & m) ? 1 : 0;
        };
        int c0, c1;
        my_cols(ncol, c0, c1);
        int v[1] = {0}, ex[1], tot[1];
        for (int s = 3 * c0; s < 3 * c1; ++s)
          v[0] += bit(r.evR, s, CLN) + bit(r.evR, s, SUBB) +
                  bit(r.evF, s, SUBB) + bit(r.evF, s, CLN);
        block_scan<1>(v, ex, tot, false, AddOp(), 0, sbuf);
        int run = ex[0];
        for (int s = 3 * c0; s < 3 * c1; ++s) {
          run += bit(r.evR, s, CLN);
          r.idR[s] = run;
          run += bit(r.evR, s, SUBB);
          r.idSR[s] = run;
          run += bit(r.evF, s, SUBB);
          r.idSF[s] = run;
          run += bit(r.evF, s, CLN);
          r.idF[s] = run;
        }
        if (tid == 0) {
          int acc = tot[0];
          for (int k = Lp; k < Lp + 3; ++k) {
            acc += bit(r.evR, k, CLN);
            r.idR[k] = acc;
            acc += bit(r.evR, k, SUBB);
            r.idSR[k] = acc;
          }
          for (int k = Lp; k < Lp + 3; ++k) {
            acc += bit(r.evF, k, SUBB);
            r.idSF[k] = acc;
            acc += bit(r.evF, k, CLN);
            r.idF[k] = acc;
          }
        }
        __syncthreads();
      }

      // ---- event assembly: compact, sort on (pos, tiekey, index), write
      {
        const int KN = cdiv(N, T);
        const int i0 = min(tid * KN, N), i1 = min(i0 + KN, N);
        int v[1] = {0}, ex[1], tot[1];
        for (int i = i0; i < i1; ++i) v[0] += item_s(r, tr, i).valid;
        block_scan<1>(v, ex, tot, false, AddOp(), 0, sbuf);
        const int nv = tot[0];
        const size_t ob = (size_t)b * Eo;
        S* o_score = (S*)a.o_score;
        auto put = [&](int row, const ItemS<S>& it, int typ) {
          a.o_pos[ob + row] = it.pos;
          a.o_typ[ob + row] = typ;
          a.o_sub[ob + row] = it.sub;
          a.o_id[ob + row] = it.id;
          o_score[ob + row] = it.score;
          a.o_trunc[ob + row] = it.trunc;
          a.o_err_pos[ob + row] = it.err_pos;
          a.o_err_typ[ob + row] = it.err_typ;
        };
        int vp = ex[0];
        for (int i = i0; i < i1; ++i) {
          const ItemS<S> it = item_s(r, tr, i);
          if (it.valid) {
            r.keys[vp++] = (long long)it.pos * POS_SHIFT +
                           (long long)it.tk * TK_SHIFT + i;
          } else {
            const int row = nv + (i - vp);
            if (row < Eo) put(row, it, 0);
          }
        }
        if (tid == 0) a.o_nev[b] = nv;
        __syncthreads();
        sort_keys(r.keys, nv);
        const int nw = nv < Eo ? nv : Eo;
        for (int row = tid; row < nw; row += T) {
          const ItemS<S> it =
              item_s(r, tr, (int)(r.keys[row] & (TK_SHIFT - 1)));
          put(row, it, it.typ);
        }
        __syncthreads();
      }
    } else {
      // ---- the per-slot event gate (evprod) ----
      for (int x = tid; x < Lp + 3; x += T) {
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
        const bool ef = fwd_slot<false>(r, x).emit &&
                        (seg_f(r, r.F, x) || fr6) &&
                        (seg_f(r, r.F + Lp, x) || fa6);
        const bool er = rev_slot<false>(r, x).emit &&
                        (seg_r(r, r.F + 2 * Lp, x) || rr6) &&
                        (seg_r(r, r.F + 3 * Lp, x) || ra6);
        r.evF[x] = ef;
        r.evR[x] = er;
      }
      __syncthreads();

      // ---- event-set ids (_assign_ids): ranks in the order rev s, fwd s
      // (s ascending), the 3 rev end slots, the 3 fwd end slots ----
      {
        int c0, c1;
        my_cols(ncol, c0, c1);
        int v[1] = {0}, ex[1], tot[1];
        for (int s = 3 * c0; s < 3 * c1; ++s) v[0] += r.evR[s] + r.evF[s];
        block_scan<1>(v, ex, tot, false, AddOp(), 0, sbuf);
        int run = ex[0];
        for (int s = 3 * c0; s < 3 * c1; ++s) {
          run += r.evR[s];
          r.idR[s] = run;
          run += r.evF[s];
          r.idF[s] = run;
        }
        if (tid == 0) {
          int acc = tot[0];
          for (int k = 0; k < 3; ++k) {
            acc += r.evR[Lp + k];
            r.idR[Lp + k] = acc;
          }
          for (int k = 0; k < 3; ++k) {
            acc += r.evF[Lp + k];
            r.idF[Lp + k] = acc;
          }
        }
        __syncthreads();
      }

      // ---- event assembly: compact, sort on (pos, index), write ----
      {
        const int KN = cdiv(N, T);
        const int i0 = min(tid * KN, N), i1 = min(i0 + KN, N);
        int v[1] = {0}, ex[1], tot[1];
        for (int i = i0; i < i1; ++i) v[0] += item(r, tr, i).valid;
        block_scan<1>(v, ex, tot, false, AddOp(), 0, sbuf);
        const int nv = tot[0];
        const size_t ob = (size_t)b * Eo;
        S* o_score = (S*)a.o_score;
        int vp = ex[0];
        for (int i = i0; i < i1; ++i) {
          const Item<S> it = item(r, tr, i);
          if (it.valid) {
            r.keys[vp++] = (long long)it.pos * 4294967296LL + i;
          } else {
            const int row = nv + (i - vp);
            if (row < Eo) {
              a.o_pos[ob + row] = it.pos;
              a.o_typ[ob + row] = 0;
              a.o_sub[ob + row] = it.sub;
              a.o_id[ob + row] = it.id;
              o_score[ob + row] = it.score;
              a.o_trunc[ob + row] = it.trunc;
            }
          }
        }
        if (tid == 0) a.o_nev[b] = nv;
        __syncthreads();
        sort_keys(r.keys, nv);
        const int nw = nv < Eo ? nv : Eo;
        for (int row = tid; row < nw; row += T) {
          const int i = (int)(r.keys[row] & 0xffffffffLL);
          const Item<S> it = item(r, tr, i);
          a.o_pos[ob + row] = it.pos;
          a.o_typ[ob + row] = it.typ;
          a.o_sub[ob + row] = it.sub;
          a.o_id[ob + row] = it.id;
          o_score[ob + row] = it.score;
          a.o_trunc[ob + row] = it.trunc;
        }
        __syncthreads();
      }
    }
  }
}

template <typename S, bool RBS, bool SUBS, class A>
int launch(const A& a, int grid, cudaStream_t st) {
  auto k = frontend_kernel<S, RBS, SUBS>;
  const size_t dyn = a.scratch ? 0 : (size_t)a.ws_bytes;
  if (dyn > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, T, dyn, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename S, bool RBS, bool SUBS>
int smem_room() {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, frontend_kernel<S, RBS, SUBS>);
  if (e != cudaSuccess) return -(int)e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)at.sharedSizeBytes;
}

template <bool SUBS>
int smem_room_of(int f64, int rbs) {
  if (f64)
    return rbs ? smem_room<double, true, SUBS>()
               : smem_room<double, false, SUBS>();
  return rbs ? smem_room<float, true, SUBS>() : smem_room<float, false, SUBS>();
}

template <bool SUBS, class A>
int launch_of(const A& a, int f64, int grid, cudaStream_t st) {
  const bool rbs = a.W > 0;
  if (f64)
    return rbs ? launch<double, true, SUBS>(a, grid, st)
               : launch<double, false, SUBS>(a, grid, st);
  return rbs ? launch<float, true, SUBS>(a, grid, st)
             : launch<float, false, SUBS>(a, grid, st);
}

}  // namespace

// Bytes of one read's workspace at Lp (f64 or f32 carry; error-free or
// substitution mode).
extern "C" long long gmt_frontend_ws(int Lp, int f64, int subs) {
  return (long long)make_layout(Lp, f64 ? 8 : 4, subs != 0).total;
}

// Dynamic shared memory a block of the instantiation may take on the
// current device (a negative cudaError on failure).
extern "C" int gmt_frontend_smem_room(int f64, int rbs, int subs) {
  return subs ? smem_room_of<true>(f64, rbs) : smem_room_of<false>(f64, rbs);
}

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
  if (!subs) return launch_of<false>(static_cast<const Args&>(a), f64, grid, st);
  a.quals = static_cast<const uint8_t*>(quals);
  a.cp = static_cast<const double*>(cp);
  a.o_err_pos = static_cast<int*>(o_err_pos);
  a.o_err_typ = static_cast<int*>(o_err_typ);
  a.pen[0] = pen_ff;
  a.pen[1] = pen_ft;
  a.pen[2] = pen_tf;
  a.pen[3] = pen_tt;
  return launch_of<true>(a, f64, grid, st);
}
