// K3: the windowed event-graph DP (Process_Events) and Trace_Back of a
// batch of reads in one launch, on Hopper (sm_90a).
//
// Replaces glimmer_mg_tpu/ops/device_predict.py:2210 _event_dp_batched and
// :2494 _traceback_batched, which the JAX package runs inside the jitted
// program of :2980 (XLA, not Pallas). Its plain PyTorch twin is
// glimmer_mg_torch/ops/event_dp.py::event_dp_traceback; the kernel matches
// it bit for bit on every output.
//
// What bounds it: not bytes. A 2,048-read chunk moves 13-19 MB (the
// event rows in, score/bp and the gene records out), 4-6 microseconds at
// 3.35 TB/s. The DP is a chain of dependent steps per read (one per
// event, up to 160), each a few warp-wide scans and reductions plus two
// serial pointer walks, so the kernel is held back by the length of that
// chain, not by memory or arithmetic throughput. The design shortens the
// chain:
//  * One warp per read, WARPS reads a block, the whole batch in one wave
//    at the main path's B = 2,048. The read's event rows (pos, typ, sub,
//    id, trunc, err_pos, err_typ) and its state (score, bp, disq, best)
//    live in shared memory from the start. The group's AdjDist tables
//    (3 x D f32) are read through the read-only cache: at the smoke's
//    D = 1,050, 12.6 KB a read, staging them in shared memory cut a
//    2,048-read chunk's blocks an SM from 7 to 2 and measured 1.2-1.4x
//    slower.
//  * Each lane loop runs over what it can touch. The opener's candidate
//    pass and the same-id pass run over the processed rows j < e, the
//    re-link snapshot computes the adjacency only for re-link candidates,
//    and the row-window check is a running maximum of pos below the
//    window (integer, so any(pos_e - pos[j] <= c) is pos_e - max pos[j] <=
//    c). Both are exact on the twin's input domain: sub in [0, 5] on every
//    row below the batch's bound (the twin gathers best at sub, which
//    raises outside it; KF's subs are 0-5) and |pos| < 2^30 (KF's are
//    below Lp). A row j >= e is then neither a between nor an extra
//    candidate, so it offers -inf at a rank above the init slot's 0 and
//    cannot win, and no difference of positions overflows.
//  * Warp reductions are REDUX instructions on order-preserving integer
//    keys, not shuffle trees: the opener's lexicographic best (value,
//    rank, position) takes three; the same-id maxima, one pass of (value,
//    largest index) a lane, take two for an f64 maximum (one for f32) and
//    one for the index at it.
//  * The re-link's successor propagation and window update are one pass
//    over the window rows (a successor of a window row lies above it, so
//    in the window; each lane adds to its own rows, in the twin's order),
//    and lane 0's
//    writes of score[e]/bp[e] share the tail that writes best: three warp
//    barriers a closing step, one an opening step. best[i], its type and
//    m_i (the last non-REV_START row of sub i at or before it) are kept in
//    every lane's registers, so an opening step reads no state but rows.
//  * The traceback is lane 0's pointer chase over the shared rows; it
//    writes the gene records into a shared 48-row buffer (the re-link
//    window's, free by then), which the warp stores coalesced.
//  * The twin runs the traceback to max(min(ne, E)) over the batch, which
//    bounds a chain only where the predecessor graph has a cycle (an
//    acyclic chain visits at most the read's own min(ne, E) rows). A read
//    chases to its own bound, and only a chain still live there scans ne
//    for the batch's. Likewise only a read with no step of its own scans
//    ne, for whether the batch's loop runs at all (the -0 rule below).
// No host sync, no device-side assert, no allocation.
//
// Where bitwise equality is at risk, and what the code does about it:
//  * Order and type of float operations follow the twin: the opener
//    candidate is (score + (S)or) + (S)dist rounded to f32; the re-link's
//    old_adj = oo + od and new_adj = or + dist are f32, diff =
//    (score_e - needed) + (S)(new_adj - old_adj); a row that both follows
//    an updated window row and is one adds the two differences in that
//    order. Reductions across lanes are max, min and argmax only, never a
//    float sum, and there is no multiplication, so FMA contraction cannot
//    change a result. Build without --use_fast_math.
//  * Ties: the opener winner is the largest f32 candidate, then the
//    smallest rank, then the first in the twin's concatenation order (rows
//    by index, the init slot, the six extra-init slots); ranks are built
//    as in _opener_best. w_fs and p_rs take the largest index. A NaN
//    candidate makes the maximum NaN and the winner index 0, as
//    torch.amax/argmax do; a NaN among the same-id scores makes m_fs NaN
//    and w_fs -1.
//  * Order within a step: score[e], bp[e] written; disqualify walk from
//    bp[p_rs]; best updated; the window (needed, bptyp, bppos, upd, diff)
//    snapshotted before any write; successors and window rows updated;
//    requalify walk from the updated bp[p_rs]. A __syncwarp separates the
//    phases. Lane 0's write of score[e]/bp[e] comes after a full-warp
//    reduction that every lane reaches after its reads of them (row e is
//    not written before step e, so those reads see the loaded values).
//  * Signed zeros: every step of the twin adds +0 to every score, which
//    turns -0 into +0; the kernel does it once when the rows are loaded
//    (when the batch's loop runs at all), after which no -0 can arise.
//  * Edges: W = min(48, E), wlo = max(e - W, 0); indices clamped to
//    [0, E-1] as the twin's gathers clamp them; the traceback writes past
//    48 genes into slot 47 while cnt keeps counting; reads with ne = 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FWD_START = 1, FWD_STOP = 2, REV_START = 3, REV_STOP = 4;
constexpr int WINDOW_ROWS = 48;
constexpr int MAX_GENES = 48;
constexpr int BIG = 1 << 29;
constexpr int WARPS = 4;          // reads (warps) a block
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* pos;
  const int* typ;
  const int* sub;
  const int* eid;
  const void* score_in;
  const uint8_t* trunc;
  const int* err_pos;
  const int* err_typ;
  const int* ne;
  const int* groups;  // (B,) bank rows
  const float* ao;    // (G, 4)
  const int* dl;      // (G, 3)
  const float* tab;   // (G, 3, D)
  void* score;
  int* bp;
  int* best;
  uint8_t* wovf;
  int* g_id;
  int* g_stop;
  int* g_len;
  int* g_sign;
  uint8_t* g_trunc;
  void* g_score;
  int* g_epos;
  int* g_etyp;
  int* cnt;
  int B, E, D, G, max_olap;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// The 48-row buffer of a warp: the re-link window's (diff, sub, upd)
// during the DP, the gene records' (score, six int fields, trunc) in the
// traceback.
template <typename S>
__host__ __device__ inline size_t win_bytes() {
  return align16((sizeof(S) + 6 * 4 + 1) * (size_t)WINDOW_ROWS);
}

// Shared memory of one warp (one read) without the tables: score, the
// int rows (bp, pos, typ, sub, id, err_pos, err_typ) and best, the byte
// rows (disq, trunc), the 48-row buffer.
template <typename S>
__host__ __device__ inline size_t warp_bytes(int E) {
  return align16(sizeof(S) * (size_t)E) + align16(4 * (size_t)(7 * E + 8)) +
         align16(2 * (size_t)E) + win_bytes<S>();
}

template <typename S>
struct Read {
  S* score;
  int* bp;
  int* pos;
  int* typ;
  int* sub;
  int* eid;
  int* errp;
  int* etyp;
  int* best;
  uint8_t* disq;
  uint8_t* trunc;
  // the 48-row buffer, as the re-link window
  S* diff_w;
  int* sub_w;
  uint8_t* upd_w;
  const float* tab;  // the group's (3, D) AdjDist tables, in the bank
  float ao0, ao1, ao2, ao3, satv0, satv1, satv2;
  int dl0, dl1, dl2, D, E, max_olap;
};

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// AdjDist table index for pred type t1 -> successor (gene.cc:798-925).
__device__ inline int adj_ti(int t1, bool succ_fs) {
  return t1 == FWD_STOP ? (succ_fs ? 0 : 1) : (succ_fs ? 2 : 0);
}

template <typename S>
__device__ inline float adj_or(const Read<S>& r, int t1, bool succ_fs) {
  return t1 == FWD_STOP ? (succ_fs ? r.ao0 : r.ao1)
                        : (t1 == REV_START ? (succ_fs ? r.ao2 : r.ao3) : 0.0f);
}

template <typename S>
__device__ inline float adj_sat(const Read<S>& r, int ti) {
  return ti == 0 ? r.satv0 : (ti == 1 ? r.satv1 : r.satv2);
}

// Exact AdjDist lookup; out-of-table indices saturate to tab[dl-1].
template <typename S>
__device__ inline float adj_dist(const Read<S>& r, int ti, int dist) {
  const int dl = ti == 0 ? r.dl0 : (ti == 1 ? r.dl1 : r.dl2);
  const int idx = dist + r.max_olap;
  if (!(idx >= 0 && idx < dl)) return adj_sat(r, ti);  // tab[dl-1]
  const int at = ti * r.D + clampi(idx, 0, r.D - 1);
  return __ldg(r.tab + at);
}

// Disqualify/Requalify chain walk (glimmer_base.cc:437-458, 2463-2480),
// bounded at E iterations as in the twin. One lane.
template <typename S>
__device__ void walk_set(const Read<S>& r, int q, int cutoff, uint8_t value) {
  for (int it = 0; it < r.E; ++it) {
    const int qc = clampi(q, 0, r.E - 1);
    const int pos_q = q >= 0 ? r.pos[qc] : -BIG;
    if (!(q >= 0 && pos_q >= cutoff)) break;
    r.disq[qc] = value;
    q = r.bp[qc];
  }
}

// (score, rank, position) of the best opener candidate so far: larger
// score, then smaller rank, then earlier position in the concatenation.
struct Cand {
  float v;
  int rank, at;
};

__device__ inline bool better(const Cand& a, const Cand& b) {
  return a.v > b.v ||
         (a.v == b.v && (a.rank < b.rank || (a.rank == b.rank && a.at < b.at)));
}

// Order-preserving unsigned keys of non-NaN floats. -0 keys below +0: the
// opener adds +0 to its candidates first, and no score is -0 (the
// signed-zero rule above).
__device__ inline unsigned okey(float v) {
  const unsigned u = __float_as_uint(v);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}

__device__ inline float from_okey(unsigned k) {
  return __uint_as_float(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

__device__ inline unsigned long long okey(double v) {
  const unsigned long long u = __double_as_longlong(v);
  return u >> 63 ? ~u : u | (1ull << 63);
}

// The lexicographic best of the lanes' candidates: the largest value
// (NaN apart), then the smallest rank, then the smallest position; three
// warp reductions.
__device__ inline Cand warp_best(Cand c) {
  const unsigned key = okey(c.v + 0.0f);  // -0 ties +0, as == does
  const unsigned k = __reduce_max_sync(FULL, key);
  const bool at_max = key == k;
  const int rank = __reduce_min_sync(FULL, at_max ? c.rank : 0x7fffffff);
  const int at = __reduce_min_sync(
      FULL, at_max && c.rank == rank ? c.at : 0x7fffffff);
  return Cand{from_okey(k), rank, at};
}

// The warp's largest value (no NaN) and, where the lane's own value is
// it, true: two 32-bit reductions for a double, one for a float.
__device__ inline float warp_max(float v, bool* mine) {
  const unsigned k = __reduce_max_sync(FULL, okey(v));
  *mine = okey(v) == k;
  return from_okey(k);
}

__device__ inline double warp_max(double v, bool* mine) {
  const unsigned long long key = okey(v);
  const unsigned hi = __reduce_max_sync(FULL, (unsigned)(key >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
  const unsigned long long k = (unsigned long long)hi << 32 | lo;
  *mine = key == k;
  return __longlong_as_double(
      (long long)(k >> 63 ? k & ~(1ull << 63) : ~k));
}

// int32 arithmetic that wraps, as the twin's int32 tensors do.
__device__ inline int wrap_rank(int sj, int E, int off) {
  return (int)((unsigned)(sj + 1) * (unsigned)(2 * E) + (unsigned)off);
}

// The opener candidate of row j for event e, f32 (_opener_best's cand_f32).
template <typename S>
__device__ inline float opener_cand(const Read<S>& r, int j, bool succ_e,
                                    int pos_e, int wlo, int W) {
  const int tj = r.typ[j];
  const int ti = adj_ti(tj, succ_e);
  const float di = (j >= wlo && j < wlo + W)
                       ? adj_dist(r, ti, pos_e - r.pos[j] - 3)
                       : adj_sat(r, ti);
  const float orr = adj_or(r, tj, succ_e);
  return (float)((r.score[j] + (S)orr) + (S)di);
}

// The best events of the six frame classes, kept warp-uniform in every
// lane's registers beside the shared copy lane 0 writes: best[i], its
// type, and m_i, the last non-REV_START row of sub i at or before best[i]
// (the twin's m_i, a function of best[i] alone, set when best[i] is).
struct Best {
  int at[6], typ[6], m[6];
};

// Best predecessor of a FWD_START/REV_STOP event e (_opener_best): the
// maximum f32 candidate and the winner's index, over the processed rows
// j < e. All lanes, uniform result.
template <typename S>
__device__ void opener_best(const Read<S>& r, const Best& bs, int e, int te,
                            int pos_e, int wlo, int W, int lane, float* m_out,
                            int* w_out) {
  const int E = r.E;
  const bool succ_e = te == FWD_START;
  const float NEG_INF = -INFINITY;
  // the init slot (rank 0, index best[0]), ahead of the pass so that its
  // table read overlaps it
  const int b0 = bs.at[0];
  const float init =
      b0 >= 0 ? opener_cand(r, clampi(b0, 0, E - 1), succ_e, pos_e, wlo, W)
              : 0.0f;
  Cand c{NEG_INF, 0x7fffffff, 0x7fffffff};
  bool nan = false;
#pragma unroll 2
  for (int j = lane; j < e; j += 32) {
    const int tj = r.typ[j], sj = r.sub[j];
    const S sc = r.score[j];
    int bsub = bs.at[0];
#pragma unroll
    for (int i = 1; i < 6; ++i)
      if (sj == i) bsub = bs.at[i];
    const bool between =
        (tj == FWD_STOP || tj == REV_START) && sc > S(0) && j > bsub;
    bool extra = false;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      extra |= bs.typ[i] == FWD_STOP
                   ? j == bs.at[i]
                   : (bs.typ[i] == REV_START && sj == i &&
                      j <= bs.at[i] && j > bs.m[i]);
    const int rank = wrap_rank(sj, E, between ? E - j : 2 * E - j);
    // read for every row, so that the table read starts with the row's
    const float cand = opener_cand(r, j, succ_e, pos_e, wlo, W);
    const float v = between || extra ? cand : NEG_INF;
    if (v != v) {
      nan = true;
    } else {
      const Cand d{v, rank, j};
      if (better(d, c)) c = d;
    }
  }
  c = warp_best(c);
  nan = __any_sync(FULL, nan);
  if (init != init) nan = true;
  const Cand ci{init, 0, E};
  if (better(ci, c)) c = ci;
  // the six extra-init slots (0 where best[i] < 0, else -inf; rank and
  // position rising with i): the best of them is the first i with
  // best[i] < 0, else i = 0
  int ix = 0;
  float vx = NEG_INF;
#pragma unroll
  for (int i = 5; i >= 0; --i)
    if (bs.at[i] < 0) {
      ix = i;
      vx = 0.0f;
    }
  const Cand cx{vx, (ix + 1) * (2 * E) + E, E + 1 + ix};
  if (better(cx, c)) c = cx;
  if (nan) {
    *m_out = NAN;
    *w_out = 0;
  } else {
    *m_out = c.v;
    *w_out = c.at < E ? c.at : (c.at == E ? b0 : -1);
  }
}

// One row of the re-link window (Process_Fwd_Stop_Rev_Start's bounded
// overlap): whether closing event e re-links row wlo + k, by how much.
template <typename S>
struct Relink {
  bool u;
  S diff;
  int sub;
  __device__ void put(const Read<S>& r, int k) const {
    r.upd_w[k] = u;
    if (u) {
      r.diff_w[k] = diff;
      r.sub_w[k] = sub;
    }
  }
};

template <typename S, bool ERR>
__device__ inline Relink<S> relink_row(const Read<S>& r, int k, int e,
                                       int wlo, int W, int te, int pos_e,
                                       S score_e) {
  Relink<S> x{false, S(0), 0};
  const int j = wlo + k;
  if (k >= W || j >= e) return x;
  const int pj = r.pos[j], tj = r.typ[j];
  if (!(3 + pos_e - pj <= r.max_olap && !r.disq[j] &&
        (tj == FWD_START || tj == REV_STOP)))
    return x;
  if (ERR) {
    const int errp_e = r.errp[e], ej = r.errp[j];
    if ((errp_e >= 0 && pj - 2 <= errp_e) || (ej >= 0 && ej <= pos_e))
      return x;
  }
  const int bpw = r.bp[j];
  const bool valid = bpw >= 0;
  const int bpc = clampi(bpw, 0, r.E - 1);
  const S needed = valid ? r.score[bpc] : S(0);
  if (!(needed < score_e)) return x;
  const int bptyp = valid ? r.typ[bpc] : 0;
  const int bppos = r.pos[bpc];
  const bool succ = tj == FWD_START;
  const float oo = adj_or(r, bptyp, succ);
  const float od = adj_dist(r, adj_ti(bptyp, succ), pj - bppos - 3);
  const float old_adj = valid ? oo + od : 0.0f;
  const float new_adj =
      adj_or(r, te, succ) + adj_dist(r, adj_ti(te, succ), pj - pos_e - 3);
  x.diff = (score_e - needed) + (S)(new_adj - old_adj);
  x.u = x.diff > S(0);
  x.sub = r.sub[j];
  return x;
}

// max(min(max(ne, 0), E)) over the batch, the twin's loop bound; all lanes.
__device__ int batch_hi(const int* ne, int B, int E, int lane) {
  int hi = 0;
  for (int i = lane; i < B; i += 32) hi = max(hi, min(max(ne[i], 0), E));
  return __reduce_max_sync(FULL, hi);
}

template <typename S, bool ERR>
__global__ void __launch_bounds__(WARPS * 32) event_dp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;
  const int E = a.E, D = a.D, max_olap = a.max_olap;

  Read<S> r;
  unsigned char* p = smem + (size_t)warp * warp_bytes<S>(E);
  r.score = reinterpret_cast<S*>(p);
  p += align16(sizeof(S) * (size_t)E);
  int* ip = reinterpret_cast<int*>(p);
  r.bp = ip;
  r.pos = ip + E;
  r.typ = ip + 2 * E;
  r.sub = ip + 3 * E;
  r.eid = ip + 4 * E;
  r.errp = ip + 5 * E;
  r.etyp = ip + 6 * E;
  r.best = ip + 7 * E;
  p += align16(4 * (size_t)(7 * E + 8));
  r.disq = p;
  r.trunc = p + E;
  p += align16(2 * (size_t)E);
  unsigned char* buf = p;  // the 48-row buffer
  r.diff_w = reinterpret_cast<S*>(buf);
  r.sub_w = reinterpret_cast<int*>(buf + sizeof(S) * WINDOW_ROWS);
  r.upd_w = buf + (sizeof(S) + 6 * 4) * WINDOW_ROWS;
  r.D = D;
  r.E = E;
  r.max_olap = max_olap;

  // the group's adjacency tables (the values of the twin's per-read
  // gather, _prefetch_adj)
  const int g = clampi(a.groups[b], 0, a.G - 1);
  const float* tab_g = a.tab + (size_t)g * 3 * D;
  r.tab = tab_g;
  r.ao0 = __ldg(a.ao + 4 * g);
  r.ao1 = __ldg(a.ao + 4 * g + 1);
  r.ao2 = __ldg(a.ao + 4 * g + 2);
  r.ao3 = __ldg(a.ao + 4 * g + 3);
  r.dl0 = __ldg(a.dl + 3 * g);
  r.dl1 = __ldg(a.dl + 3 * g + 1);
  r.dl2 = __ldg(a.dl + 3 * g + 2);
  r.satv0 = __ldg(tab_g + clampi(r.dl0 - 1, 0, D - 1));
  r.satv1 = __ldg(tab_g + D + clampi(r.dl1 - 1, 0, D - 1));
  r.satv2 = __ldg(tab_g + 2 * D + clampi(r.dl2 - 1, 0, D - 1));

  const int hi = min(max(a.ne[b], 0), E);
  // whether the twin's batch-wide loop runs at all (for the -0 rule)
  const bool batch_live = hi > 0 || batch_hi(a.ne, a.B, E, lane) > 0;
  const size_t row = (size_t)b * E;
  const S* score_in = static_cast<const S*>(a.score_in) + row;
#pragma unroll 5
  for (int j = lane; j < E; j += 32) {
    S s = __ldg(score_in + j);
    if (batch_live && s == S(0)) s = S(0);  // -0 -> +0, as x + 0 does
    r.score[j] = s;
    r.bp[j] = -2;
    r.disq[j] = 0;
    r.pos[j] = __ldg(a.pos + row + j);
    r.typ[j] = __ldg(a.typ + row + j);
    r.sub[j] = __ldg(a.sub + row + j);
    r.eid[j] = __ldg(a.eid + row + j);
    r.trunc[j] = __ldg(a.trunc + row + j) != 0;
    if (ERR) {
      r.errp[j] = __ldg(a.err_pos + row + j);
      r.etyp[j] = __ldg(a.err_typ + row + j);
    }
  }
  if (lane < 6) r.best[lane] = -1;
  __syncwarp();

  const int W = min(WINDOW_ROWS, E);
  bool wovf = false;
  int pmax = 0, pdone = 0;  // max of pos over rows [0, pdone)
  Best bs;
  int nrs[6];  // the last non-REV_START row of sub i below e
#pragma unroll
  for (int i = 0; i < 6; ++i) bs.at[i] = bs.typ[i] = bs.m[i] = nrs[i] = -1;
  for (int e = 0; e < hi; ++e) {
    const int te = r.typ[e], sub_e = r.sub[e];
    int m_e = e;  // m_i were best[sub_e] = e
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (sub_e == i) {
        if (te == REV_START)
          m_e = nrs[i];
        else
          nrs[i] = e;
      }
    if (te == 0) continue;  // padding: the twin's step changes nothing
    const int pos_e = r.pos[e], eid_e = r.eid[e];
    const S score_e0 = r.score[e];
    const bool is_open = te == FWD_START || te == REV_STOP;
    const bool is_fs = te == FWD_STOP, is_rs = te == REV_START;
    const int wlo = max(e - W, 0);

    // row-window sufficiency: a processed row below the window within
    // max_olap + 6 bases of e
    if (wlo > 0) {
      for (; pdone < wlo; ++pdone)
        pmax = pdone == 0 ? r.pos[0] : max(pmax, r.pos[pdone]);
      wovf |= pos_e - pmax <= max_olap + 6;
    }

    S new_score = score_e0;
    int new_bp = r.bp[e];
    int p_rs = -1;
    if (is_open) {
      float m;
      int w;
      opener_best(r, bs, e, te, pos_e, wlo, W, lane, &m, &w);
      new_score = score_e0 + (S)m;
      new_bp = w;
    } else if (is_fs || is_rs) {
      // same-id maxima over the processed rows, one pass: each lane's
      // maximum and the largest index at it, NaN apart
      S mloc = -INFINITY;
      int wloc = -1, prs = -1;
      bool nan = false;
      for (int j = lane; j < e; j += 32) {
        if (r.sub[j] != sub_e || r.eid[j] != eid_e) continue;
        const S s = r.score[j];
        if (s != s) {
          nan = true;
        } else if (s >= mloc) {
          wloc = j;
          mloc = s;
        }
        if (r.typ[j] != REV_START) prs = j;
      }
      bool mine;
      S m_fs = warp_max(mloc, &mine);
      nan = __any_sync(FULL, nan);
      const int w_fs = nan ? -1 : __reduce_max_sync(FULL, mine ? wloc : -1);
      if (nan) m_fs = (S)NAN;
      p_rs = __reduce_max_sync(FULL, prs);
      if (is_fs) {
        new_score = m_fs;
        new_bp = w_fs;
      } else {
        new_score = score_e0 + r.score[clampi(p_rs, 0, E - 1)];
        new_bp = p_rs;
      }
    }
    if (!(is_fs || is_rs)) {
      if (lane == 0) {
        r.score[e] = new_score;
        r.bp[e] = new_bp;
      }
      __syncwarp();
      continue;
    }

    // ---- closure (Process_Fwd_Stop_Rev_Start tail) ----
    const S score_e = new_score;
    int be = bs.at[0];
#pragma unroll
    for (int i = 1; i < 6; ++i)
      if (sub_e == i) be = bs.at[i];
    const S be_s = be >= 0 ? r.score[clampi(be, 0, E - 1)] : S(0);
    const bool upd = be_s < score_e;  // without it the rest changes nothing
    const int p_disq = is_rs ? p_rs : -1;
    const int cutoff = 3 + pos_e - max_olap;
    if (upd) {
#pragma unroll
      for (int i = 0; i < 6; ++i)
        if (sub_e == i) {
          bs.at[i] = e;
          bs.typ[i] = te;
          bs.m[i] = m_e;
        }
    }
    if (lane == 0) {
      r.score[e] = score_e;
      r.bp[e] = new_bp;
      if (upd) {
        walk_set(r, p_disq >= 0 ? r.bp[clampi(p_disq, 0, E - 1)] : -1,
                 cutoff, 1);
        if (sub_e >= 0 && sub_e < 6) r.best[sub_e] = e;
      }
    }
    __syncwarp();
    if (!upd) continue;

    // ---- bounded-overlap re-link: snapshot the window, rows lane and
    // lane + 32 (W <= 48), both read before either is written ----
    const Relink<S> x0 = relink_row<S, ERR>(r, lane, e, wlo, W, te, pos_e,
                                            score_e);
    const Relink<S> x1 = relink_row<S, ERR>(r, lane + 32, e, wlo, W, te,
                                            pos_e, score_e);
    if (lane < W) x0.put(r, lane);
    if (lane + 32 < W) x1.put(r, lane + 32);
    __syncwarp();
    // successors of updated window rows (rows above their predecessor, so
    // in the window too), then the window rows themselves: each lane its
    // own rows
    for (int j = wlo + lane; j < e; j += 32) {
      const int bj = r.bp[j];
      const int rel = bj - wlo;
      S s = r.score[j];
      if (bj >= 0 && rel >= 0 && rel < W && r.upd_w[rel] &&
          r.sub[j] == r.sub_w[rel] && j > bj)
        s += r.diff_w[rel];
      const int k = j - wlo;
      if (k >= 0 && r.upd_w[k]) {
        s += r.diff_w[k];
        r.bp[j] = e;
      }
      r.score[j] = s;
    }
    __syncwarp();
    if (lane == 0)
      walk_set(r, p_disq >= 0 ? r.bp[clampi(p_disq, 0, E - 1)] : -1, cutoff,
               0);
  }
  __syncwarp();

  // ---- outputs of the DP ----
  S* score_out = static_cast<S*>(a.score) + row;
  for (int j = lane; j < E; j += 32) {
    score_out[j] = r.score[j];
    a.bp[row + j] = r.bp[j];
  }
  if (lane < 6) a.best[6 * b + lane] = r.best[lane];
  if (lane == 0) a.wovf[b] = wovf;

  // ---- Set_Final_Event + Trace_Back: lane 0 chases bp over the shared
  // rows and writes the records into the 48-row buffer ----
  S* rec_score = reinterpret_cast<S*>(buf);
  int* rec_i = reinterpret_cast<int*>(buf + sizeof(S) * WINDOW_ROWS);
  int *rec_id = rec_i, *rec_stop = rec_i + WINDOW_ROWS,
      *rec_len = rec_i + 2 * WINDOW_ROWS, *rec_sign = rec_i + 3 * WINDOW_ROWS,
      *rec_epos = rec_i + 4 * WINDOW_ROWS, *rec_etyp = rec_i + 5 * WINDOW_ROWS;
  uint8_t* rec_trunc = buf + (sizeof(S) + 6 * 4) * WINDOW_ROWS;
  int q = r.best[0];
  S fs = q >= 0 ? r.score[clampi(q, 0, E - 1)] : S(0);
  for (int i = 1; i < 6; ++i) {
    const int bi = r.best[i];
    const S si = bi >= 0 ? r.score[clampi(bi, 0, E - 1)] : S(0);
    if (si >= fs) {
      q = bi;
      fs = si;
    }
  }
  int k = 0, cnt = 0, cur_stop = 0, rev_start_pos = 0, rev_epos = -1,
      rev_etyp = -1;
  S prev_score = S(0);
  uint8_t rev_trunc = 0;
  int lim = hi;  // the read's own bound; the batch's where a chain outlives it
  for (bool batch = false;; batch = true) {
    if (lane == 0) {
      for (; k < lim && q >= 0; ++k) {
        const int pc = clampi(q, 0, E - 1);
        const int tp = r.typ[pc], bpp = r.bp[pc], pos_p = r.pos[pc];
        const S score_p = r.score[pc];
        const uint8_t trunc_p = r.trunc[pc];
        const bool emit_f = tp == FWD_START, emit_r = tp == REV_STOP;
        const bool is_rs = tp == REV_START;
        int epos_p = -1, etyp_p = -1;
        if (ERR) {
          epos_p = r.errp[pc];
          etyp_p = r.etyp[pc];
        }
        if (emit_f || emit_r) {
          const S score_bpp =
              bpp >= 0 ? r.score[clampi(bpp, 0, E - 1)] : S(0);
          const int s = min(cnt, MAX_GENES - 1);
          rec_id[s] = r.eid[pc];
          rec_stop[s] = emit_f ? cur_stop : pos_p - 2;
          rec_len[s] = emit_f ? 2 + cur_stop - pos_p : rev_start_pos - pos_p;
          rec_sign[s] = emit_f ? 1 : -1;
          rec_trunc[s] = emit_f ? trunc_p : rev_trunc;
          rec_score[s] = emit_f ? score_p - score_bpp : prev_score - score_p;
          if (ERR) {
            rec_epos[s] = emit_f ? epos_p : rev_epos;
            rec_etyp[s] = emit_f ? etyp_p : rev_etyp;
          }
          ++cnt;
        }
        if (ERR && is_rs) {
          rev_epos = epos_p;
          rev_etyp = etyp_p;
        }
        if (tp == FWD_STOP || emit_r) cur_stop = pos_p - 2;
        if (is_rs) {
          rev_start_pos = pos_p;
          prev_score = score_p;
          rev_trunc = trunc_p;
        }
        q = bpp;
      }
    }
    if (batch || !__shfl_sync(FULL, q >= 0, 0)) break;
    lim = batch_hi(a.ne, a.B, E, lane);  // a cycle: the batch's bound
  }
  cnt = __shfl_sync(FULL, cnt, 0);
  __syncwarp();
  const int n_rec = min(cnt, MAX_GENES);
  const size_t grow = (size_t)b * MAX_GENES;
  S* g_score = static_cast<S*>(a.g_score) + grow;
  for (int s = lane; s < MAX_GENES; s += 32) {
    const bool has = s < n_rec;
    a.g_id[grow + s] = has ? rec_id[s] : 0;
    a.g_stop[grow + s] = has ? rec_stop[s] : 0;
    a.g_len[grow + s] = has ? rec_len[s] : 0;
    a.g_sign[grow + s] = has ? rec_sign[s] : 0;
    a.g_trunc[grow + s] = has ? rec_trunc[s] : 0;
    g_score[s] = has ? rec_score[s] : S(0);
    a.g_epos[grow + s] = ERR && has ? rec_epos[s] : -1;
    a.g_etyp[grow + s] = ERR && has ? rec_etyp[s] : -1;
  }
  if (lane == 0) a.cnt[b] = cnt;
}

template <typename S, bool ERR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = WARPS * warp_bytes<S>(a.E);
  auto kernel = event_dp_kernel<S, ERR>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.B + WARPS - 1) / WARPS);
  kernel<<<grid, WARPS * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Event rows (B, E):
// pos, typ, sub, eid int32, score_in f64 (f64 != 0) or f32, trunc bool,
// err_pos/err_typ int32 (has_err != 0; else ignored); ne (B,) int32;
// groups (B,) int32 rows of the bank's adjacency tables ao (G, 4) f32,
// dl (G, 3) int32 and tab (G, 3, D) f32 (clamped to [0, G)). Outputs: score (B, E),
// bp (B, E), best (B, 6), wovf (B,) bool, the eight (B, 48) gene arrays
// (g_trunc bool, g_score in the score type) and cnt (B,).
extern "C" int gmt_event_dp(
    const void* pos, const void* typ, const void* sub, const void* eid,
    const void* score_in, const void* trunc, const void* err_pos,
    const void* err_typ, const void* ne, const void* groups, const void* ao,
    const void* dl, const void* tab, void* score, void* bp, void* best, void* wovf, void* g_id,
    void* g_stop, void* g_len, void* g_sign, void* g_trunc, void* g_score,
    void* g_epos, void* g_etyp, void* cnt, int B, int E, int D, int G,
    int max_olap, int f64, int has_err, void* stream) {
  Args a{static_cast<const int*>(pos),
         static_cast<const int*>(typ),
         static_cast<const int*>(sub),
         static_cast<const int*>(eid),
         score_in,
         static_cast<const uint8_t*>(trunc),
         static_cast<const int*>(err_pos),
         static_cast<const int*>(err_typ),
         static_cast<const int*>(ne),
         static_cast<const int*>(groups),
         static_cast<const float*>(ao),
         static_cast<const int*>(dl),
         static_cast<const float*>(tab),
         score,
         static_cast<int*>(bp),
         static_cast<int*>(best),
         static_cast<uint8_t*>(wovf),
         static_cast<int*>(g_id),
         static_cast<int*>(g_stop),
         static_cast<int*>(g_len),
         static_cast<int*>(g_sign),
         static_cast<uint8_t*>(g_trunc),
         g_score,
         static_cast<int*>(g_epos),
         static_cast<int*>(g_etyp),
         static_cast<int*>(cnt),
         B,
         E,
         D,
         G,
         max_olap};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f64)
    err = has_err ? launch<double, true>(a, st) : launch<double, false>(a, st);
  else
    err = has_err ? launch<float, true>(a, st) : launch<float, false>(a, st);
  return (int)err;
}
