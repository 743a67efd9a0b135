// The dense decoder's per-node work of a frame: the node pass and the beam
// pass, two launches a frame.
//
// Replaces no TPU kernel: the JAX package's dense step
// (`aaltoasr_tpu/decoder/search_dense.py`) is XLA ops, which XLA fuses.
// The port ran the same step as ~150 PyTorch launches a frame over
// [B, N] arrays, each reading and writing whole state arrays; on a
// 571,518-node tree at B = 128 the state moved ~24x its least bytes.
// Same math, in the same order, as the plain passes of
// `aaltoasr_tpu_torch/decoder/search_dense.py` (`_node_pass_plain`,
// `_beam_pass_plain`), in float32: `__fadd_rn`/`__fmul_rn` where the plain
// path has separate ops (no contraction), one `fmaf` where it calls `fma`,
// the library `logf`; strict `>` for take_irr and take_tgt, the first index
// on ties in the 3-way, F-way and C-way maxima and in the argmax.  So the
// results are bit-identical to the plain passes on the same card.
//
// Node pass, for each row b and node n (the old state read once, the new
// state written once):
//   cross[s]  = total[s] + duration bonus of dur[s]   (total without
//               durations)
//   best3     = first max of total[n] + ts_self[n], cross[n-1] +
//               ts_prev[n], cross[n-2] + ts_skip[n]   (LOG_ZERO below 0)
//   irr       = first max over the target's irregular in-arcs f of
//               cross[src_f] + ts_grp[f]              (LOG_ZERO if none)
//   take_irr  = irr > best3; best = max(best3, irr); payloads (lms, lm,
//               rec, bo) from the winner; dur 0 on a move, else dur + 1
//   entry n   = re-entry's fan-in of the frame's C word ends (the [B, C]
//               arrays the host computed): e = first max over c of
//               (left_mem & first_mem of c's pair row & alive) ? r_total :
//               LOG_ZERO; take_tgt = e > (alive ? best : LOG_ZERO)
//   total     = (take_tgt ? e : cur) + obs[b, frame, pdf[n]]
// and each row's maximum of total: a warp reduction, a shared-memory
// atomic a warp and row, one device atomic a block and row.  In freeze
// mode a row past its n_frames copies its old state.
// Beam pass: alive &= total >= max - beam; dead totals LOG_ZERO; the
// row's first best node (as `torch.argmax`) gives `fin` (rec, max,
// max - lm_scale * lms, lms), written where frame < n_frames.  Its last
// block for a row (a counter a row) writes `fin` and clears the row's
// scratch for the next frame.
//
// What bounds it: bytes.  A frame reads and writes the carried state,
// 37 bytes a node (total, lms, bo float32; lm, dur, rec int64; alive),
// 5.41 GB at B = 128 and 571,518 nodes: 1.62 ms at 3.35 TB/s.  The
// operations are a few dozen a node.  Design:
// * A thread takes 4 adjacent nodes and walks the rows of its block's row
//   group, so the per-node tables (transition terms, duration parameters,
//   pdf, the irregular and entry rows) stay in registers across rows.
// * The state's rows are padded to a multiple of 4 nodes (`ld`), so every
//   access is a coalesced 16-byte load or store (4-byte for alive).
// * The n-1 and n-2 neighbours come from the next lower lane by shuffle;
//   a warp's lane 0 reads its two from device memory (cached).
// * The grid is node tiles x row groups, sized to about 64 blocks an SM
//   (B is split over blockIdx.y when the node tiles are few).  A block
//   keeps its rows' maxima in shared memory, so a row costs no barrier.
// * The irregular in-arcs' sources are gathers.  A target with fewer
//   arcs than F scans one padding entry (all its padding entries are
//   equal, and the first wins a tie).  A dead source (total exactly
//   LOG_ZERO) skips its duration read where the wrapper has checked that
//   no bonus can move LOG_ZERO (`dead_skip`).
// * Frozen rows are copied, not skipped, so the counted bytes are moved.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr float LOG_ZERO = -1.0e30f;
constexpr float HALF_ZERO = -5.0e29f;   // LOG_ZERO / 2, as float32
constexpr int C = 4;                    // re-entries a frame (REENTRY_WIDTH)
constexpr int VEC = 4;                  // nodes a thread
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = VEC * THREADS;     // nodes a block
constexpr int BLOCKS_PER_SM = 64;       // grid target
constexpr int MAX_ROWS = 4096;          // rows a block (its shared keys)

struct NodeArgs {
  // old state [B, ld] (read only here) and new state [B, ld]
  const float* total; const float* lms; const long long* lm;
  const long long* dur; const long long* rec; const float* bo;
  const unsigned char* alive;
  float* o_total; float* o_lms; long long* o_lm; long long* o_dur;
  long long* o_rec; float* o_bo; unsigned char* o_alive;
  // per-node tables [ld]: transition terms, duration parameters (valid,
  // lncoef, invb, const), pdf, irregular row (Mi: none), entry row (M:
  // none)
  const float* ts_self; const float* ts_prev; const float* ts_skip;
  const float4* dur4; const int* pdf; const int* grp_inv;
  const int* entry_inv;
  // irregular in-arcs [Mi, F] and the entries to scan a row [Mi]
  const int* grp_src; const float* ts_grp; const int* grp_cnt;
  // pair membership [NC, M] and [NR, M]
  const unsigned char* left_mem; const unsigned char* first_mem;
  // the frame's re-entries [B, C]
  const float* r_total; const unsigned char* r_alive;
  const long long* r_pair; const float* r_lms; const long long* r_lm;
  const long long* r_rec; const float* r_bo;
  // obs at the frame: obs[b * obs_b + s]
  const float* obs; long long obs_b;
  const long long* n_frames;
  unsigned* acc;        // [B] row maxima as ordered keys
  float* rowmax;        // [B]
  int frame, B, N, ld, Mi, F, M, NR, max_dur, rows, freeze, dead_skip;
};

struct BeamArgs {
  float* total; unsigned char* alive;
  const float* lms; const long long* rec;
  const long long* n_frames;
  unsigned* acc; unsigned long long* arg; unsigned* done;
  float* rowmax;
  long long* fin_rec; float* fin_mx; float* fin_am; float* fin_lms;
  float beam, neg_lm_scale;
  int frame, B, N, ld, rows, freeze;
};

// float32 -> unsigned key of the same order (no NaN in the state)
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// `_dur_bonus`: valid * (lncoef * log(d) - d * invb + const), d =
// clamp(dur + 1, 1, max_dur), each op rounded as the plain path's
__device__ __forceinline__ float dur_bonus(long long dur, float4 p,
                                           int max_dur) {
  long long dd = dur + 1;
  dd = dd < 1 ? 1 : (dd > max_dur ? max_dur : dd);
  const float d = (float)dd;
  const float a = __fmul_rn(p.y, logf(d));
  const float b = __fmul_rn(d, p.z);
  return __fmul_rn(p.x, __fadd_rn(__fsub_rn(a, b), p.w));
}

template <bool kDur>
__device__ __forceinline__ float cross_of(float total, long long dur,
                                          float4 p, int max_dur) {
  return kDur ? __fadd_rn(total, dur_bonus(dur, p, max_dur)) : total;
}

__device__ __forceinline__ long long shfl_up_ll(long long x) {
  return (long long)__shfl_up_sync(0xffffffffu, (unsigned long long)x, 1);
}

template <typename T>
__device__ __forceinline__ void ld2(const T* p, T (&x)[VEC]) {
  // 4 int64 values as two 16-byte loads
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void st2(long long* p, const long long (&x)[VEC]) {
  reinterpret_cast<longlong2*>(p)[0] = make_longlong2(x[0], x[1]);
  reinterpret_cast<longlong2*>(p)[1] = make_longlong2(x[2], x[3]);
}

__device__ __forceinline__ void ldf(const float* p, float (&x)[VEC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

__device__ __forceinline__ void stf(float* p, const float (&x)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void ldi(const int* p, int (&x)[VEC]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}

template <bool kDur>
__global__ void __launch_bounds__(THREADS)
dense_node_kernel(NodeArgs a) {
  extern __shared__ unsigned smax[];   // [rows]: the block's row maxima
  const int t = threadIdx.x, lane = t & 31;
  const int n0 = (blockIdx.x * THREADS + t) * VEC;
  const bool in = n0 < a.ld;          // the 4 nodes lie in the padded row

  // per-node tables, kept across the rows
  float ts0[VEC], ts1[VEC], ts2[VEC];
  float4 dp[VEC];
  int pdf[VEC], gi[VEC], ei[VEC];
  if (in) {
    ldf(a.ts_self + n0, ts0);
    ldf(a.ts_prev + n0, ts1);
    ldf(a.ts_skip + n0, ts2);
    ldi(a.pdf + n0, pdf);
    ldi(a.grp_inv + n0, gi);
    ldi(a.entry_inv + n0, ei);
#pragma unroll
    for (int k = 0; k < VEC; ++k) dp[k] = __ldg(a.dur4 + n0 + k);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      ts0[k] = ts1[k] = ts2[k] = 0.f;
      dp[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      pdf[k] = 0; gi[k] = a.Mi; ei[k] = a.M;
    }
  }
  const int b0 = blockIdx.y * a.rows;
  const int b1 = min(a.B, b0 + a.rows);
  for (int r = t; r < b1 - b0; r += THREADS) smax[r] = 0u;
  __syncthreads();
  for (int b = b0; b < b1; ++b) {
    const size_t row = (size_t)b * a.ld;
    const bool v = a.frame < __ldg(a.n_frames + b);
    if (a.freeze && !v) {
      // a frozen row keeps its state: copied, as the counted bytes say
      if (in) {
        float x[VEC]; long long y[VEC];
        ldf(a.total + row + n0, x); stf(a.o_total + row + n0, x);
        ldf(a.lms + row + n0, x); stf(a.o_lms + row + n0, x);
        ldf(a.bo + row + n0, x); stf(a.o_bo + row + n0, x);
        ld2(a.lm + row + n0, y); st2(a.o_lm + row + n0, y);
        ld2(a.dur + row + n0, y); st2(a.o_dur + row + n0, y);
        ld2(a.rec + row + n0, y); st2(a.o_rec + row + n0, y);
        *reinterpret_cast<unsigned*>(a.o_alive + row + n0) =
            __ldg(reinterpret_cast<const unsigned*>(a.alive + row + n0));
      }
      if (blockIdx.x == 0 && t == 0) a.rowmax[b] = -INFINITY;
      continue;
    }

    float tot[VEC], lms[VEC], bo[VEC];
    long long lm[VEC], dur[VEC], rec[VEC];
    if (in) {
      ldf(a.total + row + n0, tot);
      ldf(a.lms + row + n0, lms);
      ldf(a.bo + row + n0, bo);
      ld2(a.lm + row + n0, lm);
      ld2(a.dur + row + n0, dur);
      ld2(a.rec + row + n0, rec);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        tot[k] = lms[k] = bo[k] = 0.f;
        lm[k] = dur[k] = rec[k] = 0;
      }
    }
    // X[0], X[1]: nodes n0-2, n0-1; X[2 + k]: node n0 + k
    float xc[VEC + 2], xl[VEC + 2], xb[VEC + 2];
    long long xm[VEC + 2], xr[VEC + 2];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xc[2 + k] = cross_of<kDur>(tot[k], dur[k], dp[k], a.max_dur);
      xl[2 + k] = lms[k]; xb[2 + k] = bo[k];
      xm[2 + k] = lm[k]; xr[2 + k] = rec[k];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // h = 0: n0-2 (lane-1's k=2); 1: n0-1
      xc[h] = __shfl_up_sync(0xffffffffu, xc[4 + h], 1);
      xl[h] = __shfl_up_sync(0xffffffffu, xl[4 + h], 1);
      xb[h] = __shfl_up_sync(0xffffffffu, xb[4 + h], 1);
      xm[h] = shfl_up_ll(xm[4 + h]);
      xr[h] = shfl_up_ll(xr[4 + h]);
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = n0 - 2 + h;
        if (in && s >= 0) {
          xc[h] = kDur ? cross_of<kDur>(__ldg(a.total + row + s),
                                        __ldg(a.dur + row + s),
                                        __ldg(a.dur4 + s), a.max_dur)
                       : __ldg(a.total + row + s);
          xl[h] = __ldg(a.lms + row + s);
          xb[h] = __ldg(a.bo + row + s);
          xm[h] = __ldg(a.lm + row + s);
          xr[h] = __ldg(a.rec + row + s);
        }
      }
    }
    if (n0 == 0) {                    // before the row: the shifts' fills
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xc[h] = LOG_ZERO; xl[h] = 0.f; xb[h] = 0.f; xm[h] = 0; xr[h] = -1;
      }
    }

    // nodes in descending order: node k's results replace X[2 + k],
    // tot[k] and dur[k], which no lower node reads
    unsigned o_al = 0;
    float mx = -INFINITY;
#pragma unroll
    for (int k = VEC - 1; k >= 0; --k) {
      // phase 1: the three shifts and the irregular in-arcs
      const float c0 = __fadd_rn(tot[k], ts0[k]);
      const float c1 = __fadd_rn(xc[k + 1], ts1[k]);
      const float c2 = __fadd_rn(xc[k], ts2[k]);
      float best3 = c0;
      int ch = 0;
      if (c1 > best3) { best3 = c1; ch = 1; }
      if (c2 > best3) { best3 = c2; ch = 2; }
      float irr = LOG_ZERO;
      int sw = 0;
      const bool has_irr = gi[k] < a.Mi;
      if (has_irr) {
        const size_t g = (size_t)gi[k] * a.F;
        const int cnt = __ldg(a.grp_cnt + gi[k]);
        for (int f = 0; f < cnt; ++f) {
          const int s = __ldg(a.grp_src + g + f);
          const float ts = __ldg(a.ts_grp + g + f);
          const float st = __ldg(a.total + row + s);
          float cx = st;
          if (kDur && !(a.dead_skip && st == LOG_ZERO))
            cx = __fadd_rn(st, dur_bonus(__ldg(a.dur + row + s),
                                         __ldg(a.dur4 + s), a.max_dur));
          const float val = __fadd_rn(cx, ts);
          if (f == 0 || val > irr) { irr = val; sw = s; }
        }
      }
      const bool take_irr = irr > best3;
      const float best = take_irr ? irr : best3;
      float nl, nb;
      long long nm, nr, nd;
      if (take_irr) {
        if (has_irr) {
          nl = __ldg(a.lms + row + sw);
          nm = __ldg(a.lm + row + sw);
          nr = __ldg(a.rec + row + sw);
          nb = __ldg(a.bo + row + sw);
        } else {
          nl = 0.f; nm = 0; nr = -1; nb = 0.f;
        }
        nd = 0;
      } else {
        nl = ch == 0 ? xl[k + 2] : (ch == 1 ? xl[k + 1] : xl[k]);
        nb = ch == 0 ? xb[k + 2] : (ch == 1 ? xb[k + 1] : xb[k]);
        nm = ch == 0 ? xm[k + 2] : (ch == 1 ? xm[k + 1] : xm[k]);
        nr = ch == 0 ? xr[k + 2] : (ch == 1 ? xr[k + 1] : xr[k]);
        nd = ch != 0 ? 0 : dur[k] + 1;
      }
      bool al = best > HALF_ZERO;

      // phase 3's fan-in at entry nodes
      float sc = LOG_ZERO;
      bool ev = false;
      int w = 0;
      const int m = ei[k];
      if (m < a.M) {
        const size_t rb = (size_t)b * C;
        for (int c = 0; c < C; ++c) {
          const long long pair = __ldg(a.r_pair + rb + c);
          const bool ok = __ldg(a.r_alive + rb + c) &&
                          __ldg(a.left_mem + (size_t)(pair / a.NR) * a.M + m) &&
                          __ldg(a.first_mem + (size_t)(pair % a.NR) * a.M + m);
          const float val = ok ? __ldg(a.r_total + rb + c) : LOG_ZERO;
          if (c == 0 || val > sc) { sc = val; w = c; }
        }
        ev = sc > HALF_ZERO;
      }
      const float cur = al ? best : LOG_ZERO;
      const bool take_tgt = sc > cur;
      if (take_tgt) {
        const size_t rw = (size_t)b * C + w;
        nl = ev ? __ldg(a.r_lms + rw) : 0.f;
        nm = ev ? __ldg(a.r_lm + rw) : 0;
        nr = ev ? __ldg(a.r_rec + rw) : 0;
        nb = ev ? __ldg(a.r_bo + rw) : 0.f;
        nd = 0;
        al = true;
      }
      // observation
      const float nt = __fadd_rn(take_tgt ? sc : cur,
                                 __ldg(a.obs + b * a.obs_b + pdf[k]));
      tot[k] = nt; xl[k + 2] = nl; xb[k + 2] = nb;
      xm[k + 2] = nm; dur[k] = nd; xr[k + 2] = nr;
      o_al |= (unsigned)al << (8 * k);
      if (n0 + k < a.N) mx = fmaxf(mx, nt);
    }
    if (in) {
      stf(a.o_total + row + n0, tot);
      *reinterpret_cast<float4*>(a.o_lms + row + n0) =
          make_float4(xl[2], xl[3], xl[4], xl[5]);
      *reinterpret_cast<float4*>(a.o_bo + row + n0) =
          make_float4(xb[2], xb[3], xb[4], xb[5]);
      reinterpret_cast<longlong2*>(a.o_lm + row + n0)[0] =
          make_longlong2(xm[2], xm[3]);
      reinterpret_cast<longlong2*>(a.o_lm + row + n0)[1] =
          make_longlong2(xm[4], xm[5]);
      st2(a.o_dur + row + n0, dur);
      reinterpret_cast<longlong2*>(a.o_rec + row + n0)[0] =
          make_longlong2(xr[2], xr[3]);
      reinterpret_cast<longlong2*>(a.o_rec + row + n0)[1] =
          make_longlong2(xr[4], xr[5]);
      *reinterpret_cast<unsigned*>(a.o_alive + row + n0) = o_al;
    }
    // the row's maximum: the warp's, then the block's in shared memory
    // (no barrier a row)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) atomicMax(smax + (b - b0), fkey(mx));
  }
  // one atomic a row a block
  __syncthreads();
  for (int r = t; r < b1 - b0; r += THREADS)
    if (smax[r] != 0u) atomicMax(a.acc + b0 + r, smax[r]);
}

__global__ void __launch_bounds__(THREADS)
dense_beam_kernel(BeamArgs a) {
  __shared__ unsigned long long red[2][WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = (blockIdx.x * THREADS + t) * VEC;
  const bool in = n0 < a.ld;
  const int b0 = blockIdx.y * a.rows;
  const int b1 = min(a.B, b0 + a.rows);
  int par = 0;
  for (int b = b0; b < b1; ++b) {
    const size_t row = (size_t)b * a.ld;
    const bool v = a.frame < __ldg(a.n_frames + b);
    if (a.freeze && !v) continue;
    const float mx = unkey(__ldcg(a.acc + b));
    const float thr = __fsub_rn(mx, a.beam);
    unsigned long long key = 0;
    if (in) {
      float4 tv = *reinterpret_cast<const float4*>(a.total + row + n0);
      unsigned al = *reinterpret_cast<const unsigned*>(a.alive + row + n0);
      float x[VEC] = {tv.x, tv.y, tv.z, tv.w};
      unsigned nal = 0;
      bool changed = false;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const bool keep = ((al >> (8 * k)) & 0xffu) && x[k] >= thr;
        const float nt = keep ? x[k] : LOG_ZERO;
        changed |= __float_as_uint(nt) != __float_as_uint(x[k]);
        x[k] = nt;
        nal |= (unsigned)keep << (8 * k);
        const int n = n0 + k;
        if (n < a.N) {
          const unsigned long long kk =
              ((unsigned long long)fkey(nt) << 32) | (0xffffffffu - (unsigned)n);
          key = kk > key ? kk : key;
        }
      }
      if (changed)
        *reinterpret_cast<float4*>(a.total + row + n0) =
            make_float4(x[0], x[1], x[2], x[3]);
      if (nal != al) *reinterpret_cast<unsigned*>(a.alive + row + n0) = nal;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xffffffffu, key, o);
      key = y > key ? y : key;
    }
    if (lane == 0) red[par][warp] = key;
    __syncthreads();
    if (warp == 0) {
      unsigned long long r = lane < WARPS ? red[par][lane] : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long y = __shfl_xor_sync(0xffffffffu, r, o);
        r = y > r ? y : r;
      }
      if (lane == 0) {
        atomicMax(a.arg + b, r);
        __threadfence();
        const unsigned prev = atomicAdd(a.done + b, 1u);
        if (prev == gridDim.x - 1) {
          // the row's last block: every block's key is in
          __threadfence();
          const unsigned long long best = atomicAdd(a.arg + b, 0ull);
          const unsigned n = 0xffffffffu - (unsigned)(best & 0xffffffffull);
          a.rowmax[b] = mx;
          if (v) {
            const float bl = __ldcg(a.lms + row + n);
            a.fin_rec[b] = __ldcg(a.rec + row + n);
            a.fin_mx[b] = mx;
            a.fin_am[b] = fmaf(a.neg_lm_scale, bl, mx);
            a.fin_lms[b] = bl;
          }
          a.acc[b] = 0u;
          a.arg[b] = 0ull;
          a.done[b] = 0u;
        }
      }
    }
    par ^= 1;
  }
}

// grid: node tiles x row groups, about BLOCKS_PER_SM blocks an SM
dim3 grid_of(int B, int ld, int* rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
  }
  const int tiles = (ld + TILE - 1) / TILE;
  int groups = (sms * BLOCKS_PER_SM + tiles - 1) / tiles;
  groups = groups < 1 ? 1 : (groups > B ? B : groups);
  *rows = (B + groups - 1) / groups;
  if (*rows > MAX_ROWS) *rows = MAX_ROWS;
  groups = (B + *rows - 1) / *rows;
  return dim3(tiles, groups);
}

}  // namespace

extern "C" {

// Nodes a thread and threads a block: the wrapper pads rows to VEC.
int dense_node_vec() { return VEC; }

// Both kernels' grid on the current device for B rows of ld nodes: the
// rows a block, with the node tiles and row groups in tiles/groups.
int dense_node_plan(int B, int ld, int* tiles, int* groups) {
  int rows = 0;
  const dim3 grid = grid_of(B, ld, &rows);
  *tiles = (int)grid.x;
  *groups = (int)grid.y;
  return rows;
}

// The node pass of one frame.  State arrays [B, ld] (ld a multiple of 4,
// 16-byte aligned): old total, lms, lm, dur, rec, bo, alive, then the new
// ones (distinct); per-node tables [ld]; grp_src/ts_grp [Mi, F] with the
// entries to scan grp_cnt [Mi]; left_mem [NC, M], first_mem [NR, M]; the
// re-entries [B, 4]; obs at the frame with row stride obs_b; n_frames [B];
// acc [B] (zero before the first frame; the beam pass clears it);
// rowmax [B].  `frame` is the frame index (a row is valid while frame <
// n_frames[b]); `freeze` copies the old state of rows past it.  Launches
// on `stream`; returns the CUDA error.
int dense_node_launch(
    const float* total, const float* lms, const long long* lm,
    const long long* dur, const long long* rec, const float* bo,
    const unsigned char* alive, float* o_total, float* o_lms,
    long long* o_lm, long long* o_dur, long long* o_rec, float* o_bo,
    unsigned char* o_alive, const float* ts_self, const float* ts_prev,
    const float* ts_skip, const float* dur4, const int* pdf,
    const int* grp_inv, const int* entry_inv, const int* grp_src,
    const float* ts_grp, const int* grp_cnt, const unsigned char* left_mem,
    const unsigned char* first_mem, const float* r_total,
    const unsigned char* r_alive, const long long* r_pair,
    const float* r_lms, const long long* r_lm, const long long* r_rec,
    const float* r_bo, const float* obs, long long obs_b,
    const long long* n_frames, unsigned* acc, float* rowmax, int frame,
    int B, int N, int ld, int Mi, int F, int M, int NR, int max_dur,
    int has_dur, int freeze, int dead_skip, void* stream) {
  if (B < 1 || N < 1 || ld < N || ld % VEC != 0 || Mi < 1 || F < 1 ||
      M < 1 || NR < 1 || max_dur < 1)
    return (int)cudaErrorInvalidValue;
  NodeArgs a{total,    lms,      lm,        dur,       rec,     bo,
             alive,    o_total,  o_lms,     o_lm,      o_dur,   o_rec,
             o_bo,     o_alive,  ts_self,   ts_prev,   ts_skip,
             reinterpret_cast<const float4*>(dur4),    pdf,     grp_inv,
             entry_inv, grp_src, ts_grp,    grp_cnt,   left_mem, first_mem,
             r_total,  r_alive,  r_pair,    r_lms,     r_lm,    r_rec,
             r_bo,     obs,      obs_b,     n_frames,  acc,     rowmax,
             frame,    B,        N,         ld,        Mi,      F,
             M,        NR,       max_dur,   0,         freeze,  dead_skip};
  const dim3 grid = grid_of(B, ld, &a.rows);
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)a.rows * sizeof(unsigned);
  if (has_dur)
    dense_node_kernel<true><<<grid, THREADS, smem, s>>>(a);
  else
    dense_node_kernel<false><<<grid, THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The beam pass of the same frame, in place on the new total and alive
// [B, ld]; lms and rec [B, ld] give `fin` at the best node; acc, arg and
// done [B] are the rows' scratch (zero between frames); rowmax [B];
// fin_rec/fin_mx/fin_am/fin_lms [B] are written where frame < n_frames.
int dense_beam_launch(float* total, unsigned char* alive, const float* lms,
                      const long long* rec, const long long* n_frames,
                      unsigned* acc, unsigned long long* arg, unsigned* done,
                      float* rowmax, long long* fin_rec, float* fin_mx,
                      float* fin_am, float* fin_lms, float beam,
                      float neg_lm_scale, int frame, int B, int N, int ld,
                      int freeze, void* stream) {
  if (B < 1 || N < 1 || ld < N || ld % VEC != 0)
    return (int)cudaErrorInvalidValue;
  BeamArgs a{total,   alive,  lms,    rec,    n_frames, acc,
             arg,     done,   rowmax, fin_rec, fin_mx,  fin_am,
             fin_lms, beam,   neg_lm_scale, frame, B,   N,
             ld,      0,      freeze};
  const dim3 grid = grid_of(B, ld, &a.rows);
  dense_beam_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
