// The time recursions of the masked forward-backward, one launch a batch.
//
// Replaces no TPU kernel: the JAX package runs these recursions as
// `lax.scan`s that XLA compiles into one device loop
// (`aaltoasr_tpu/train/estep.py`, `masked_forward_backward` and its shift
// form).  The port ran them as Python frame loops of ~47 (forward) and ~48
// (backward) small PyTorch launches a frame, so the host's issue of those
// launches set the E-step's pace; here each recursion is one block's loop
// over time.  Same math, in the same order, as the plain loops of
// `aaltoasr_tpu_torch/train/estep.py`, for utterance b with n =
// n_frames[b] (clipped to [1, T]):
//
//   alpha[0, p]  = max(obs[0, p] + entry[p], LOG_ZERO)
//   alpha[t, p]  = max(lse(in-edges' alpha[t-1, s] + w) + obs[t, p],
//                      LOG_ZERO)                           0 < t < n
//   alpha[t]     = alpha[n-1]                              t >= n
//   beta[t]      = final                                   t >= n-1
//   beta[t, p]   = max(lse(out-edges' w + obs[t+1, q] + beta[t+1, q]),
//                      LOG_ZERO)                           t < n-1
//
// in one of the two forms a graph comes in:
// * gather (`_gather_loops`): the edges are the [P, F] fan tables
//   in_src/in_logp and out_tgt/out_logp; the plain max-shifted logsumexp
//   (`ops/logsemiring.py`): m = max_f x_f; s = sum_f exp(x_f - max(m,
//   LOG_ZERO/2)) in fan order; LOG_ZERO where m <= LOG_ZERO/2;
// * shift (`_shift_loops`, graphs from `shift_compile`): the in-edges from
//   p, p-1 and p-2 with weights sh_logp[0..2, p] and the irregular edges
//   (ir_src, ir_tgt, ir_logp), which `_scatter_lse` reduces per position
//   (max from LOG_ZERO over all of them, then the sum of exp over the
//   live ones in edge order), and `_lse4` over the four classes (max,
//   clamped at LOG_ZERO, and the four exponentials summed left to right).
//   The wrapper hands the kernel the irregular edges grouped by target
//   (forward) and by source (backward), each group in edge order.
// Float32 throughout, IEEE expf/logf (no fast math); no atomics, so a
// result repeats bit for bit.  Each form's card and CPU results agree as
// closely as the same PyTorch ops on both did.
//
// What bounds it: neither bytes nor operations.  A step reads one [P] row
// of obs and writes one of alphas or betas (2.8 KB each at P=704) and
// takes ~5 exponentials a position; the ~T steps of a recursion are a
// chain, each needing the whole previous row.  So a block's time is
// T x (one step's latency): shared-memory gathers, the exponentials and
// one barrier.  Measured on an H100 (700 W; PERF.md, `chip_smoke.py` phase
// 16) at the E-step cell's batch (B=8, T_pad=2,048, P=704, F=4): 2.25 ms a
// launch in the shift form, 2.47 in the gather form, ~1.1-1.2 us a step,
// against 0.041 ms to move its bytes once; the plain loops took 3,198 ms
// (shift) and 1,051 ms (gather) to issue.  At P=8,192 (B=8, T_pad=1,000,
// nothing in shared memory): 10.6 ms (shift) and 19.1 ms (gather) a
// launch, against 1,655 ms and 626 ms for the plain loops.
// Design:
// * Grid 2B: block b < B runs utterance b's forward recursion, block B + b
//   its backward one (it needs no alphas), so the two run at once.  A
//   forward-only launch has B blocks.
// * One thread a position (strided when P > 1,024).  The previous row sits
//   in shared memory, double-buffered, so a step takes one barrier.
// * The obs rows stream through a ring of RING rows in shared memory,
//   4-byte cp.async copies issued RING - 1 steps ahead, so a step does not
//   wait on device memory.  The backward step gathers obs[t+1] at its
//   targets, hence the ring in shared memory and not in registers.
// * The gather form's fan tables, [P, F] each, are copied to shared memory
//   as [F, P] (int32 indices) when they fit beside the rows, and read
//   through the read-only path otherwise; the shift form's weights and
//   irregular edges are read through the read-only path.  Indices are
//   clamped into [0, P).
// * Where the rows and the ring do not fit (P > 5,811: an MMI
//   denominator), the block keeps nothing in shared memory: the previous
//   row is the output row it wrote one step before, read back through L2
//   (`__ldcg`, coherent within the launch), and obs is read where it lies.
//   Same steps, same sums, one barrier a step.
// * Frozen rows need no step: past n the forward block writes row n-1
//   again, and the backward block writes `final` from n-1 on first.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float LOG_ZERO = -1.0e30f;
constexpr int RING = 8;              // obs rows in the ring
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_MAX = 232448;     // a Hopper block's shared memory

struct Args {
  const float* obs;                  // [B, T, P]
  // gather form
  const long long* in_src;           // [B, P, F]
  const float* in_logp;              // [B, P, F]
  const long long* out_tgt;          // [B, P, F]
  const float* out_logp;             // [B, P, F]
  // shift form
  const float* sh_logp;              // [B, 3, P]
  const int* ir_src;                 // [B, E]
  const int* ir_tgt;                 // [B, E]
  const float* ir_logp;              // [B, E]
  const int* ir_by_tgt;              // [B, E] edge ids grouped by target
  const int* ir_tgt_start;           // [B, P + 1] each group's start
  const int* ir_by_src;              // [B, E] edge ids grouped by source
  const int* ir_src_start;           // [B, P + 1]
  const float* entry;                // [B, P]
  const float* final_;               // [B, P]
  const long long* n_frames;         // [B]
  float* alphas;                     // [B, T, P]
  float* betas;                      // [B, T, P], or null: forward only
  int B, T, P, F, E;
};

size_t smem_bytes(int P, int F, bool rows, bool tables) {
  return (rows ? sizeof(float) * (size_t)P * (2 + RING) : 0) +
         (tables ? (sizeof(int) + sizeof(float)) * (size_t)P * F : 0);
}

__device__ __forceinline__ float clamp_lz(float v) {
  return v < LOG_ZERO ? LOG_ZERO : v;      // torch.clamp: NaN stays NaN
}

__device__ __forceinline__ int clamp_idx(long long i, int P) {
  return (int)(i < 0 ? 0 : (i >= P ? P - 1 : i));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One utterance's fan tables: [F, P] in shared memory, or the [P, F]
// device arrays read through the read-only path.
template <bool kSmem>
struct Tables {
  const int* s_idx;
  const float* s_lp;
  const long long* g_idx;
  const float* g_lp;
  int P, F;

  __device__ __forceinline__ int idx(int p, int f) const {
    if (kSmem) return s_idx[f * P + p];
    return clamp_idx(__ldg(g_idx + (size_t)p * F + f), P);
  }
  __device__ __forceinline__ float lp(int p, int f) const {
    if (kSmem) return s_lp[f * P + p];
    return __ldg(g_lp + (size_t)p * F + f);
  }
};

// The plain logsumexp over the fan of x(f), in fan order.
template <class X>
__device__ __forceinline__ float lse_fan(int F, X x) {
  float m = x(0);
  for (int f = 1; f < F; ++f) m = fmaxf(m, x(f));
  const float safe = m < 0.5f * LOG_ZERO ? 0.5f * LOG_ZERO : m;
  float s = 0.f;
  for (int f = 0; f < F; ++f) s += expf(x(f) - safe);
  return m <= 0.5f * LOG_ZERO ? LOG_ZERO : safe + logf(s);
}

// `_scatter_lse` at one position over its irregular edges order[lo, hi):
// x(e) the edge's term.
template <class X>
__device__ __forceinline__ float lse_irregular(const int* order, int lo,
                                               int hi, X x) {
  float mx = LOG_ZERO;
  for (int i = lo; i < hi; ++i) mx = fmaxf(mx, x(__ldg(order + i)));
  float s = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float c = x(__ldg(order + i));
    if (c > 0.5f * LOG_ZERO) s += expf(c - mx);
  }
  return s > 0.f ? mx + logf(fmaxf(s, 1e-30f)) : LOG_ZERO;
}

// `_lse4`: the shift form's four classes.
__device__ __forceinline__ float lse4(float a, float b, float c, float d) {
  const float m = fmaxf(fmaxf(a, b), fmaxf(c, d));
  const float ms = m < LOG_ZERO ? LOG_ZERO : m;
  const float s =
      expf(a - ms) + expf(b - ms) + expf(c - ms) + expf(d - ms);
  return m > 0.5f * LOG_ZERO ? ms + logf(fmaxf(s, 1e-30f)) : LOG_ZERO;
}

// kShift: the shift form (else the gather form); kRows: the two rows and
// the obs ring in shared memory (else the previous row is read back from
// the output, obs where it lies); kTables (gather form, with kRows): the
// fan tables there too.
template <bool kShift, bool kRows, bool kTables>
__global__ void __launch_bounds__(MAX_THREADS)
    chain_fb_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, F = a.F, T = a.T;
  const bool fwd = (int)blockIdx.x < a.B;
  const int b = fwd ? blockIdx.x : blockIdx.x - a.B;
  float* rows = reinterpret_cast<float*>(smem_raw);        // [2, P]
  float* ring = rows + 2 * (size_t)P;                      // [RING, P]
  int* s_idx = reinterpret_cast<int*>(ring + (size_t)RING * P);  // [F, P]
  float* s_lp = reinterpret_cast<float*>(s_idx + (size_t)F * P); // [F, P]

  const long long n64 = a.n_frames[b];
  const int n = (int)(n64 < 1 ? 1 : (n64 > T ? T : n64));
  const float* obs = a.obs + (size_t)b * T * P;
  float* out = (fwd ? a.alphas : a.betas) + (size_t)b * T * P;
  const size_t tab = (size_t)b * P * F;
  const long long* g_idx =
      kShift ? nullptr : (fwd ? a.in_src : a.out_tgt) + tab;
  const float* g_lp =
      kShift ? nullptr : (fwd ? a.in_logp : a.out_logp) + tab;
  const Tables<kTables> tb{s_idx, s_lp, g_idx, g_lp, P, F};
  // shift form: weights, and the irregular edges grouped at this end
  const float* w = kShift ? a.sh_logp + (size_t)b * 3 * P : nullptr;
  const size_t eb = (size_t)b * a.E;
  const int* ir_other = kShift ? (fwd ? a.ir_src : a.ir_tgt) + eb : nullptr;
  const float* ir_lp = kShift ? a.ir_logp + eb : nullptr;
  const int* ir_order = kShift ? (fwd ? a.ir_by_tgt : a.ir_by_src) + eb
                               : nullptr;
  const int* ir_start =
      kShift ? (fwd ? a.ir_tgt_start : a.ir_src_start) + (size_t)b * (P + 1)
             : nullptr;

  if (kTables) {
    for (int i = threadIdx.x; i < P * F; i += blockDim.x) {
      const int p = i / F, f = i - p * F;
      s_idx[f * P + p] = clamp_idx(__ldg(g_idx + i), P);
      s_lp[f * P + p] = __ldg(g_lp + i);
    }
  }
  // the first row: forward row 0, backward rows n-1 .. T-1
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    if (fwd) {
      const float v =
          clamp_lz(__ldg(obs + p) + __ldg(a.entry + (size_t)b * P + p));
      if (kRows) rows[p] = v;
      out[p] = v;
    } else {
      const float v = __ldg(a.final_ + (size_t)b * P + p);
      if (kRows) rows[p] = v;
      for (int t = n - 1; t < T; ++t) out[(size_t)t * P + p] = v;
    }
  }

  // step k computes row t = k+1 (forward) or n-2-k (backward) from obs
  // row k+1 or n-1-k, which the ring's slot k % RING holds
  const int steps = n - 1;
  auto fetch = [&](int k) {
    if (k < steps) {
      const float* src = obs + (size_t)(fwd ? k + 1 : n - 1 - k) * P;
      float* dst = ring + (size_t)(k % RING) * P;
      for (int p = threadIdx.x; p < P; p += blockDim.x)
        cp_async4(dst + p, src + p);
    }
    cp_async_commit();                  // empty past the end: counts stay even
  };
  if (kRows)
    for (int k = 0; k < RING - 1; ++k) fetch(k);

  for (int k = 0; k < steps; ++k) {
    if (kRows) cp_async_wait<RING - 2>();   // this thread's copies of row k
    __syncthreads();                    // everyone's, and the previous row
    const int t = fwd ? k + 1 : n - 2 - k;
    const float* prev = kRows ? rows + (size_t)(k & 1) * P
                              : out + (size_t)(fwd ? t - 1 : t + 1) * P;
    float* next = rows + (size_t)((k + 1) & 1) * P;
    const float* ob = kRows ? ring + (size_t)(k % RING) * P
                            : obs + (size_t)(fwd ? t : t + 1) * P;
    // shared memory, or the row this block wrote (L2) and obs (read-only)
    auto row = [&](int q) { return kRows ? prev[q] : __ldcg(prev + q); };
    auto ob_at = [&](int q) { return kRows ? ob[q] : __ldg(ob + q); };
    // the backward target term obs[t+1, q] + beta[t+1, q]
    auto t_ob = [&](int q) { return ob_at(q) + row(q); };
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      float v;
      if (kShift) {
        const int lo = __ldg(ir_start + p), hi = __ldg(ir_start + p + 1);
        if (fwd) {
          const float c0 = row(p) + __ldg(w + p);
          const float c1 = (p >= 1 ? row(p - 1) : LOG_ZERO) + __ldg(w + P + p);
          const float c2 =
              (p >= 2 ? row(p - 2) : LOG_ZERO) + __ldg(w + 2 * P + p);
          const float ci = lse_irregular(ir_order, lo, hi, [&](int e) {
            return row(clamp_idx(__ldg(ir_other + e), P)) + __ldg(ir_lp + e);
          });
          v = clamp_lz(lse4(c0, c1, c2, ci) + ob_at(p));
        } else {
          const float c0 = __ldg(w + p) + t_ob(p);
          const float c1 =
              p + 1 < P ? __ldg(w + P + p + 1) + t_ob(p + 1) : LOG_ZERO;
          const float c2 =
              p + 2 < P ? __ldg(w + 2 * P + p + 2) + t_ob(p + 2) : LOG_ZERO;
          const float ci = lse_irregular(ir_order, lo, hi, [&](int e) {
            return __ldg(ir_lp + e) + t_ob(clamp_idx(__ldg(ir_other + e), P));
          });
          v = clamp_lz(lse4(c0, c1, c2, ci));
        }
      } else if (fwd) {
        v = lse_fan(F,
                    [&](int f) { return row(tb.idx(p, f)) + tb.lp(p, f); });
        v = clamp_lz(v + ob_at(p));
      } else {
        v = clamp_lz(lse_fan(F, [&](int f) {
          const int q = tb.idx(p, f);
          return tb.lp(p, f) + ob_at(q) + row(q);
        }));
      }
      if (kRows) next[p] = v;
      out[(size_t)t * P + p] = v;
    }
    if (kRows) fetch(k + RING - 1);     // its slot was read before the barrier
  }
  if (kRows) cp_async_wait_all();
  if (fwd) {                            // frozen rows: this thread's own
    const float* last = kRows ? rows + (size_t)(steps & 1) * P
                              : out + (size_t)(n - 1) * P;
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const float v = last[p];
      for (int t = n; t < T; ++t) out[(size_t)t * P + p] = v;
    }
  }
}

template <bool kShift, bool kRows, bool kTables>
int launch(const Args& a, bool backward, cudaStream_t stream) {
  // once per process: allow the full shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      chain_fb_kernel<kShift, kRows, kTables>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int threads =
      a.P >= MAX_THREADS ? MAX_THREADS : ((a.P + 31) / 32) * 32;
  chain_fb_kernel<kShift, kRows, kTables>
      <<<a.B * (backward ? 2 : 1), threads,
         smem_bytes(a.P, a.F, kRows, kTables), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Obs rows in the ring: the wrapper's shared-memory plan uses it.
int chain_fb_ring() { return RING; }

// obs [B, T, P]; the gather form's in_src/in_logp and out_tgt/out_logp
// [B, P, F] (indices int64), or, with `shift`, sh_logp [B, 3, P] and the
// irregular edges ir_src/ir_tgt/ir_logp [B, E] (int32 indices) with their
// ids grouped by target and by source [B, E] and each group's start
// [B, P + 1] (int32); entry and final [B, P], n_frames [B] int64 ->
// alphas and, when betas is not null, betas [B, T, P].  All contiguous,
// on the device; the other form's pointers may be null.  `plan`: 2 keeps
// the rows, the obs ring and the fan tables in shared memory, 1 the rows
// and the ring, 0 nothing (the wrapper checks what fits; the shift form
// takes 1 or 0).  Launches on `stream`; returns the CUDA error.
int chain_fb_launch(const float* obs, const long long* in_src,
                    const float* in_logp, const long long* out_tgt,
                    const float* out_logp, const float* sh_logp,
                    const int* ir_src, const int* ir_tgt,
                    const float* ir_logp, const int* ir_by_tgt,
                    const int* ir_tgt_start, const int* ir_by_src,
                    const int* ir_src_start, const float* entry,
                    const float* final_, const long long* n_frames,
                    float* alphas, float* betas, int B, int T, int P, int F,
                    int E, int shift, int plan, void* stream) {
  if (B < 1 || T < 1 || P < 1 || F < 1 || E < 0 || plan < 0 || plan > 2 ||
      (shift && plan == 2) ||
      smem_bytes(P, F, plan > 0, plan > 1) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const Args a{obs,        in_src,    in_logp,      out_tgt,   out_logp,
               sh_logp,    ir_src,    ir_tgt,       ir_logp,   ir_by_tgt,
               ir_tgt_start, ir_by_src, ir_src_start, entry,   final_,
               n_frames,   alphas,    betas,        B,         T,
               P,          F,         E};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool bw = betas != nullptr;
  if (shift)
    return plan == 1 ? launch<true, true, false>(a, bw, s)
                     : launch<true, false, false>(a, bw, s);
  return plan == 2 ? launch<false, true, true>(a, bw, s)
         : plan == 1 ? launch<false, true, false>(a, bw, s)
                     : launch<false, false, false>(a, bw, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
