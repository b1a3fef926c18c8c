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
// serial pointer walks, so the kernel is held back by the latency of that
// chain, not by memory or arithmetic throughput.
//
// Design: one warp per read, WARPS reads a block. The read's event rows
// (pos, typ, sub, id, err_pos) and its state (score, bp, disq, best) live
// in shared memory; its group's adjacency tables are read from the bank
// (a few entries a step, cached). Each read loops over its own
// events e < ne[b]: rows at e >= ne[b] are typ == 0 padding, on which a
// step of the twin's batch-wide loop changes nothing. The traceback's
// chain stops where the twin's does: at a negative index or after
// max(ne) steps, the batch's bound, which each block reads from ne. Lane-parallel: the
// E-wide opener scan, the same-id maxima, the 48-row re-link window and
// the full-row successor propagation. One lane: the disqualify/requalify
// chain walks (bounded at E, as in the twin) and the traceback's chain.
// No host sync, no device-side assert, no allocation.
//
// Where bitwise equality is at risk, and what the code does about it:
//  * Order and type of float operations follow the twin: the opener
//    candidate is (score + (S)or) + (S)dist rounded to f32; the re-link's
//    old_adj = oo + od and new_adj = or + dist are f32, diff =
//    (score_e - needed) + (S)(new_adj - old_adj). Reductions across lanes
//    are max, min and argmax only, never a float sum, and there is no
//    multiplication, so FMA contraction cannot change a result. Build
//    without --use_fast_math.
//  * Ties: the opener winner is the largest f32 candidate, then the
//    smallest rank, then the first in the twin's concatenation order (rows
//    by index, the init slot, the six extra-init slots); ranks are built
//    as in _opener_best. w_fs and p_rs take the largest index. A NaN
//    candidate makes the maximum NaN and the winner index 0, as
//    torch.amax/argmax do.
//  * Order within a step: write score[e], bp[e]; disqualify walk from
//    bp[p_rs]; update best; snapshot the window (needed, bptyp, bppos,
//    upd, diff) before any write; propagate to successors over the row;
//    add to the window; write bp in the window; requalify walk from the
//    updated bp[p_rs]. A __syncwarp separates the phases.
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
constexpr int WARPS = 4;  // reads (warps) a block
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

// Shared memory of one warp (one read).
template <typename S>
__host__ __device__ inline size_t warp_bytes(int E) {
  return align16(sizeof(S) * (size_t)(E + WINDOW_ROWS))  // score, diff_w
         + align16(4 * (size_t)(6 * E + WINDOW_ROWS + 8))  // ints
         + align16((size_t)(E + WINDOW_ROWS));             // disq, upd_w
}

template <typename S>
struct Read {
  S* score;
  S* diff_w;
  int* bp;
  int* pos;
  int* typ;
  int* sub;
  int* eid;
  int* errp;
  int* sub_w;
  int* best;
  const float* tab;  // the group's (3, D) AdjDist tables, in device memory
  uint8_t* disq;
  uint8_t* upd_w;
  // adjacency of the read's group
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
  const bool ok = idx >= 0 && idx < dl;
  const int ie = ok ? clampi(idx, 0, r.D - 1) : clampi(dl - 1, 0, r.D - 1);
  return r.tab[ti * r.D + ie];
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

__device__ inline Cand warp_best(Cand c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Cand d;
    d.v = __shfl_xor_sync(FULL, c.v, o);
    d.rank = __shfl_xor_sync(FULL, c.rank, o);
    d.at = __shfl_xor_sync(FULL, c.at, o);
    if (better(d, c)) c = d;
  }
  return c;
}

template <typename S>
__device__ inline S warp_max(S v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const S w = __shfl_xor_sync(FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
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

// Best predecessor of a FWD_START/REV_STOP event e (_opener_best): the
// maximum f32 candidate and the winner's index. All lanes, uniform result.
template <typename S>
__device__ void opener_best(const Read<S>& r, int e, int te, int pos_e,
                            int wlo, int W, int lane, float* m_out,
                            int* w_out) {
  const int E = r.E;
  const bool succ_e = te == FWD_START;
  int bst[6], btyp[6], mloc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    bst[i] = r.best[i];
    btyp[i] = bst[i] >= 0 ? r.typ[clampi(bst[i], 0, E - 1)] : -1;
    mloc[i] = -1;
  }
  // m_i: the last processed non-REV_START row of sub i at or before best[i]
  for (int j = lane; j < e; j += 32) {
    const int sj = r.sub[j];
    if (r.typ[j] == REV_START) continue;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (sj == i && j <= bst[i]) mloc[i] = j;
  }
  int m6[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) m6[i] = __reduce_max_sync(FULL, mloc[i]);

  const float NEG_INF = -INFINITY;
  Cand c{NEG_INF, 0x7fffffff, 0x7fffffff};
  bool nan = false;
  for (int j = lane; j < E; j += 32) {
    const int tj = r.typ[j], sj = r.sub[j];
    const S sc = r.score[j];
    const bool processed = j < e;
    int bsub = bst[0];
#pragma unroll
    for (int i = 1; i < 6; ++i)
      if (sj == i) bsub = bst[i];
    const bool between = processed && (tj == FWD_STOP || tj == REV_START) &&
                         sc > S(0) && j > bsub;
    bool extra = false;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      extra |= btyp[i] == FWD_STOP
                   ? j == bst[i]
                   : (btyp[i] == REV_START && processed && sj == i &&
                      j <= bst[i] && j > m6[i]);
    const int rank = between ? (sj + 1) * (2 * E) + (E - j)
                             : (sj + 1) * (2 * E) + E + (E - j);
    const float v =
        (between || extra) ? opener_cand(r, j, succ_e, pos_e, wlo, W) : NEG_INF;
    if (v != v) {
      nan = true;
    } else {
      const Cand d{v, rank, j};
      if (better(d, c)) c = d;
    }
  }
  c = warp_best(c);
  nan = __any_sync(FULL, nan);
  // the init slot (rank 0, index best[0]) and six extra-init slots
  const int b0 = bst[0];
  const float init =
      b0 >= 0 ? opener_cand(r, clampi(b0, 0, E - 1), succ_e, pos_e, wlo, W)
              : 0.0f;
  if (init != init) nan = true;
  const Cand ci{init, 0, E};
  if (better(ci, c)) c = ci;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const Cand cx{bst[i] >= 0 ? NEG_INF : 0.0f, (i + 1) * (2 * E) + E,
                  E + 1 + i};
    if (better(cx, c)) c = cx;
  }
  if (nan) {
    *m_out = NAN;
    *w_out = 0;
  } else {
    *m_out = c.v;
    *w_out = c.at < E ? c.at : (c.at == E ? b0 : -1);
  }
}

template <typename S, bool ERR>
__global__ void __launch_bounds__(WARPS * 32) event_dp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int E = a.E, D = a.D, max_olap = a.max_olap;
  const size_t wb = warp_bytes<S>(E);

  // The twin's batch-wide loop bound, max(min(ne, E)): the traceback runs
  // to it (past a read's own chain only where the predecessor graph has a
  // cycle, which build_bank's min_gene_len > max_olap + 3 rules out).
  int hi_all = 0;
  for (int i = threadIdx.x; i < a.B; i += blockDim.x)
    hi_all = max(hi_all, min(max(a.ne[i], 0), E));
  hi_all = __reduce_max_sync(FULL, hi_all);
  int* block_hi = reinterpret_cast<int*>(smem + WARPS * wb);
  if (lane == 0) block_hi[warp] = hi_all;
  __syncthreads();
  int batch_hi = 0;
  for (int w = 0; w < WARPS; ++w) batch_hi = max(batch_hi, block_hi[w]);
  const bool batch_live = batch_hi > 0;

  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;

  Read<S> r;
  unsigned char* p = smem + (size_t)warp * wb;
  r.score = reinterpret_cast<S*>(p);
  r.diff_w = r.score + E;
  p += align16(sizeof(S) * (size_t)(E + WINDOW_ROWS));
  int* ip = reinterpret_cast<int*>(p);
  r.bp = ip;
  r.pos = ip + E;
  r.typ = ip + 2 * E;
  r.sub = ip + 3 * E;
  r.eid = ip + 4 * E;
  r.errp = ip + 5 * E;
  r.sub_w = ip + 6 * E;
  r.best = r.sub_w + WINDOW_ROWS;
  p += align16(4 * (size_t)(6 * E + WINDOW_ROWS + 8));
  r.disq = p;
  r.upd_w = p + E;
  r.D = D;
  r.E = E;
  r.max_olap = max_olap;

  const size_t row = (size_t)b * E;
  const S* score_in = static_cast<const S*>(a.score_in) + row;
  for (int j = lane; j < E; j += 32) {
    S s = score_in[j];
    if (batch_live && s == S(0)) s = S(0);  // -0 -> +0, as x + 0 does
    r.score[j] = s;
    r.bp[j] = -2;
    r.disq[j] = 0;
    r.pos[j] = a.pos[row + j];
    r.typ[j] = a.typ[row + j];
    r.sub[j] = a.sub[row + j];
    r.eid[j] = a.eid[row + j];
    if (ERR) r.errp[j] = a.err_pos[row + j];
  }
  if (lane < 6) r.best[lane] = -1;
  // the group's adjacency tables, read by group from the bank (the values
  // of the twin's per-read gather, _prefetch_adj)
  const int g = clampi(a.groups[b], 0, a.G - 1);
  r.ao0 = a.ao[4 * g];
  r.ao1 = a.ao[4 * g + 1];
  r.ao2 = a.ao[4 * g + 2];
  r.ao3 = a.ao[4 * g + 3];
  r.dl0 = a.dl[3 * g];
  r.dl1 = a.dl[3 * g + 1];
  r.dl2 = a.dl[3 * g + 2];
  r.tab = a.tab + (size_t)g * 3 * D;
  r.satv0 = r.tab[clampi(r.dl0 - 1, 0, D - 1)];
  r.satv1 = r.tab[D + clampi(r.dl1 - 1, 0, D - 1)];
  r.satv2 = r.tab[2 * D + clampi(r.dl2 - 1, 0, D - 1)];
  __syncwarp();

  const int hi = min(max(a.ne[b], 0), E);
  const int W = min(WINDOW_ROWS, E);
  bool wovf = false;
  for (int e = 0; e < hi; ++e) {
    const int te = r.typ[e];
    if (te == 0) continue;  // padding: the twin's step changes nothing
    const int pos_e = r.pos[e], sub_e = r.sub[e], eid_e = r.eid[e];
    const S score_e0 = r.score[e];
    const bool is_open = te == FWD_START || te == REV_STOP;
    const bool is_fs = te == FWD_STOP, is_rs = te == REV_START;
    const int wlo = max(e - W, 0);

    // row-window sufficiency
    bool out = false;
    for (int j = lane; j < wlo; j += 32)
      out |= pos_e - r.pos[j] <= max_olap + 6;
    wovf |= __any_sync(FULL, out);

    S new_score = score_e0;
    int new_bp = r.bp[e];
    int p_rs = -1;
    if (is_open) {
      float m;
      int w;
      opener_best(r, e, te, pos_e, wlo, W, lane, &m, &w);
      new_score = score_e0 + (S)m;
      new_bp = w;
    } else if (is_fs || is_rs) {
      // same-id maxima over the processed rows
      S mloc = -INFINITY;
      bool nan = false;
      int prs = -1;
      for (int j = lane; j < e; j += 32) {
        if (r.sub[j] != sub_e || r.eid[j] != eid_e) continue;
        const S s = r.score[j];
        if (s != s)
          nan = true;
        else if (s > mloc)
          mloc = s;
        if (r.typ[j] != REV_START) prs = j;
      }
      S m_fs = warp_max(mloc);
      nan = __any_sync(FULL, nan);
      int wloc = -1;
      if (!nan)
        for (int j = lane; j < e; j += 32)
          if (r.sub[j] == sub_e && r.eid[j] == eid_e && r.score[j] == m_fs)
            wloc = j;
      const int w_fs = __reduce_max_sync(FULL, wloc);
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
    __syncwarp();
    if (lane == 0) {
      r.score[e] = new_score;
      r.bp[e] = new_bp;
    }
    __syncwarp();
    if (!(is_fs || is_rs)) continue;

    // ---- closure (Process_Fwd_Stop_Rev_Start tail) ----
    const S score_e = new_score;
    const int sub_c = clampi(sub_e, 0, 5);
    const int be = r.best[sub_c];
    const S be_s = be >= 0 ? r.score[clampi(be, 0, E - 1)] : S(0);
    __syncwarp();  // every lane has read best before lane 0 writes it
    if (!(be_s < score_e)) continue;  // without `do` the rest changes nothing
    const int p_disq = is_rs ? p_rs : -1;
    const int cutoff = 3 + pos_e - max_olap;
    if (lane == 0) {
      walk_set(r, p_disq >= 0 ? r.bp[clampi(p_disq, 0, E - 1)] : -1, cutoff,
               1);
      if (sub_e >= 0 && sub_e < 6) r.best[sub_e] = e;
    }
    __syncwarp();

    // ---- bounded-overlap re-link: snapshot the window ----
    const int errp_e = ERR ? r.errp[e] : -1;
    for (int k = lane; k < W; k += 32) {
      const int j = wlo + k;
      const int bpw = r.bp[j];
      const bool valid = bpw >= 0;
      const int bpc = clampi(bpw, 0, E - 1);
      const S needed = valid ? r.score[bpc] : S(0);
      const int bptyp = valid ? r.typ[bpc] : 0;
      const int bppos = r.pos[bpc];
      const int pj = r.pos[j], tj = r.typ[j];
      bool cand = j < e && 3 + pos_e - pj <= max_olap && !r.disq[j] &&
                  (tj == FWD_START || tj == REV_STOP) && needed < score_e;
      if (ERR) {
        const int ej = r.errp[j];
        const bool ov = (errp_e >= 0 && pj - 2 <= errp_e) ||
                        (ej >= 0 && ej <= pos_e);
        cand = cand && !ov;
      }
      const bool succ = tj == FWD_START;
      const float oo = adj_or(r, bptyp, succ);
      const float od = adj_dist(r, adj_ti(bptyp, succ), pj - bppos - 3);
      const float old_adj = valid ? oo + od : 0.0f;
      const float new_adj =
          adj_or(r, te, succ) + adj_dist(r, adj_ti(te, succ), pj - pos_e - 3);
      const S diff = (score_e - needed) + (S)(new_adj - old_adj);
      r.upd_w[k] = cand && diff > S(0);
      r.diff_w[k] = diff;
      r.sub_w[k] = r.sub[j];
    }
    __syncwarp();
    // successor propagation over the full row
    for (int j = lane; j < e; j += 32) {
      const int bj = r.bp[j];
      const int rel = bj - wlo;
      if (bj >= 0 && rel >= 0 && rel < W && r.upd_w[rel] &&
          r.sub[j] == r.sub_w[rel] && j > bj)
        r.score[j] += r.diff_w[rel];
    }
    __syncwarp();
    for (int k = lane; k < W; k += 32) {
      if (r.upd_w[k]) {
        r.score[wlo + k] += r.diff_w[k];
        r.bp[wlo + k] = e;
      }
    }
    __syncwarp();
    if (lane == 0)
      walk_set(r, p_disq >= 0 ? r.bp[clampi(p_disq, 0, E - 1)] : -1, cutoff,
               0);
    __syncwarp();
  }

  // ---- outputs of the DP ----
  S* score_out = static_cast<S*>(a.score) + row;
  for (int j = lane; j < E; j += 32) {
    score_out[j] = r.score[j];
    a.bp[row + j] = r.bp[j];
  }
  if (lane < 6) a.best[6 * b + lane] = r.best[lane];
  if (lane == 0) a.wovf[b] = wovf;

  // ---- Set_Final_Event + Trace_Back ----
  const size_t grow = (size_t)b * MAX_GENES;
  S* g_score = static_cast<S*>(a.g_score) + grow;
  for (int k = lane; k < MAX_GENES; k += 32) {
    a.g_id[grow + k] = 0;
    a.g_stop[grow + k] = 0;
    a.g_len[grow + k] = 0;
    a.g_sign[grow + k] = 0;
    a.g_trunc[grow + k] = 0;
    g_score[k] = S(0);
    a.g_epos[grow + k] = -1;
    a.g_etyp[grow + k] = -1;
  }
  __syncwarp();
  if (lane != 0) return;
  int fe = r.best[0];
  S fs = fe >= 0 ? r.score[clampi(fe, 0, E - 1)] : S(0);
  for (int i = 1; i < 6; ++i) {
    const int bi = r.best[i];
    const S si = bi >= 0 ? r.score[clampi(bi, 0, E - 1)] : S(0);
    if (si >= fs) {
      fe = bi;
      fs = si;
    }
  }
  int q = fe, cur_stop = 0, rev_start_pos = 0, rev_epos = -1, rev_etyp = -1;
  int cnt = 0;
  S prev_score = S(0);
  uint8_t rev_trunc = 0;
  for (int k = 0; k < batch_hi && q >= 0; ++k) {
    const int pc = clampi(q, 0, E - 1);
    const int tp = r.typ[pc], bpp = r.bp[pc], pos_p = r.pos[pc];
    const S score_p = r.score[pc];
    const uint8_t trunc_p = a.trunc[row + pc] != 0;
    const bool emit_f = tp == FWD_START, emit_r = tp == REV_STOP;
    const bool is_rs = tp == REV_START;
    int epos_p = -1, etyp_p = -1;
    if (ERR) {
      epos_p = a.err_pos[row + pc];
      etyp_p = a.err_typ[row + pc];
    }
    if (emit_f || emit_r) {
      const S score_bpp = bpp >= 0 ? r.score[clampi(bpp, 0, E - 1)] : S(0);
      const size_t g = grow + clampi(cnt, 0, MAX_GENES - 1);
      a.g_id[g] = r.eid[pc];
      a.g_stop[g] = emit_f ? cur_stop : pos_p - 2;
      a.g_len[g] = emit_f ? 2 + cur_stop - pos_p : rev_start_pos - pos_p;
      a.g_sign[g] = emit_f ? 1 : -1;
      a.g_trunc[g] = emit_f ? trunc_p : rev_trunc;
      g_score[g - grow] = emit_f ? score_p - score_bpp : prev_score - score_p;
      if (ERR) {
        a.g_epos[g] = emit_f ? epos_p : rev_epos;
        a.g_etyp[g] = emit_f ? etyp_p : rev_etyp;
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
  a.cnt[b] = cnt;
}

template <typename S, bool ERR>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = WARPS * warp_bytes<S>(a.E) + 16 * WARPS;
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
