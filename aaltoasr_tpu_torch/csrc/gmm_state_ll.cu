// Fused GMM tied-state log-likelihoods: K weight slabs folded by an online
// logsumexp, without the [T, G] Gaussian matrix or the [T, S, K] gather.
//
// Replaces the TPU kernel `aaltoasr_tpu/ops/gmm_pallas.py` (`_kernel`,
// launched by `_fused_state_ll`).  Same math as the plain version
// `aaltoasr_tpu_torch/ops/gmm_cuda.py:reference_state_ll`:
//
//   xq   = [x^2, x, 1]                         [T, 2D+1]  (built here)
//   e_k  = xq @ we[k][:2D+1]                   [T, Spp]   per slot k < K
//   m, s = online logsumexp over k             (running max, rescaled sum)
//   out  = m <= LOG_ZERO/2 ? LOG_ZERO : m + log(s)
//
// we[k] holds the score columns of each state's k-th mixture component,
// with the Gaussian constant and the log mixture weight folded into row 2D
// (the constant-one input); `FusedGmmScorer.from_scorer` builds it.
//
// What bounds it on the card: the product, 2*(2D+1)*K flops per (frame,
// state), 129.2 GFLOP for 32 utterances x 10 s (T=39,936) at D=39, K=8,
// Spp=2,560.  It runs on the tensor cores as 3xTF32: every float32
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), and each
// k-step accumulates lo*hi + hi*lo + hi*hi in float32, which keeps the
// product about as close to float64 as float32 is (one TF32 pass is 0.22
// off, and LNA codes step every 1/1820).  That is 388 GFLOP of TF32 work:
// 0.78 ms at the H100's 495 TFLOP/s, the bound (float32 on the CUDA
// cores: 1.93 ms).  Device memory moves only x, the slabs and the 409 MB
// [T, Spp] result (0.12 ms at 3.35 TB/s).  The online logsumexp takes one
// exponential per (frame, state, slot), 0.82 G at that shape (~0.2 ms of
// the SMs' MUFU rate).
//
// Measured on an H100 (700 W; PERF.md, tools/torch_gmm_kernel_ab.py):
// 2.111 ms at that shape, 37% of the bound.  mma.sync m16n8k8 issued the
// TF32 work at ~90 TFLOP/s whatever the tile, hence wgmma; what held
// wgmma back was serial work around it in a block (the slab copies, the
// fold, the xq prologue), so two blocks share an SM and the copies are
// TMA bulk copies on barriers.  What is left, by ablation: the products
// exposed (~0.73 ms of the 2.111), the fold (~0.24 ms), the copies
// (~0.10 ms), and ~1 ms of work around them (the xq prologue, the
// per-k-step ldmatrix and split of A, barrier waits, the epilogue).
//
// Design:
// * The slabs come from the wrapper split into TF32 hi and lo parts and
//   tiled as shared memory holds them: per (slot, 64-state tile, k-slice
//   of KS), the hi then the lo part, each as the 8 x 16-byte core
//   matrices of wgmma's no-swizzle K-major layout.  A stage is then one
//   contiguous 8 KB run, loaded by one TMA bulk copy.  The table is made
//   once per scorer, on the host.
// * One block per (BT-frame, 64-state) tile: BT/64 warpgroups, each
//   owning 64 frames.  The prologue builds the block's xq tile [BT, KD] in
//   shared memory from x, once, and keeps it for all K slots.
// * The slices stream through a ring of STAGES stages, each with a full
//   barrier (the copy landed) and an empty one (every warp has read it).
//   Thread 0 refills a stage one slice after its last use, so the next
//   slices load while the tensor cores work.  Shared memory grows with D
//   only through the xq tile; the wrapper takes the 64-frame tile when
//   the batch tile's does not fit (D > 167).
// * Per k-step of 8, each warp loads its 16 rows of xq with ldmatrix and
//   splits them in registers (the A operand of wgmma m64n64k8 comes from
//   registers, laid out as mma.sync's), and the warpgroup issues the three
//   products with B from shared memory.
// * After a slot's last k-slice each thread folds its 32 accumulators into
//   its running max m (registers) and sum s (shared memory, which keeps
//   the block at 128 registers a thread, two blocks an SM) with one
//   exponential: d = e - m, u = exp(-|d|); d <= 0: s += u; else
//   s = s*u + 1, m = e.  LOG_ZERO-padded slots give u = 0.  Only the final
//   [BT, 64] tile is written, as float2 stores that fill whole 32-byte
//   sectors, marked streaming so they do not push the slabs out of L2.
// * Two tile shapes; the wrapper picks by T: two warpgroups per block
//   for batches and for one utterance at 2,704 states; one for fewer
//   frames, where the blocks would not fill the SMs twice.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int KS = 16;             // depth of one k-slice
constexpr int BS = 64;             // states per block: wgmma's N
constexpr float LOG_ZERO = -1.0e30f;
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use

template <int WGS_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int WGS = WGS_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = WGS * 128;
  static constexpr int BT = WGS * 64;           // frames per block
  static_assert(STAGES >= 2, "a ring needs two stages");
};

constexpr int SLICE = BS * KS;                  // floats of one slab slice

// the two tiles: warpgroups (64 frames each), ring stages, blocks per SM
// for the register budget.  The wrapper's TILES, RING and DEPTH_STEP
// (ops/gmm_cuda.py) state the same shapes to pick a tile and lay out
// the slab table.
using Batch = Tile<2, 3, 2>;
using Utt = Tile<1, 3, 3>;

// xq row stride for depth KD (a multiple of KS): an odd multiple of 4
// floats, so the 8 rows of an ldmatrix hit distinct banks
__host__ __device__ inline int xq_stride(int KD) { return KD + 4; }

// the ring of hi/lo slice pairs, the running sums, the xq tile, and a
// full and an empty barrier per stage
template <class C>
size_t smem_bytes(int KD) {
  return sizeof(float) * ((size_t)C::STAGES * 2 * SLICE +
                          (size_t)C::THREADS * 32 +
                          (size_t)C::BT * xq_stride(KD)) +
         16 * C::STAGES;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a copy that never
// lands faults the kernel instead of hanging it
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (long n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n > (1L << 22)) __trap();
  }
}

// one TMA bulk copy of `bytes` from global to shared memory, completing
// on barrier `bar`, which expects them
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ldmatrix on float32 data: an 8x8 b16 matrix is 8 rows of 4 floats, and
// thread l receives float (l & 3) of row (l >> 2), which is the tf32
// A fragment layout of mma.m16n8k8 and of wgmma's register A.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// B operand descriptor of a [64, 8] K-major tile at shared address `addr`,
// no swizzle: 8 x 16-byte core matrices, the next 4 k 128 bytes on (LBO),
// the next 8 states KS/4 core matrices on (SBO)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((KS / 4) * 128 >> 4) << 32);
}

// d (+)= a * B over one k-step of 8: wgmma m64n64k8, A from registers
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// the accumulators are written by the async products: keep the compiler
// from moving their other uses across the fences and waits
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
gmm_state_ll_kernel(const float* __restrict__ x,
                    const float* __restrict__ w, float* __restrict__ out,
                    int T, int D, int K, int KD, int Spp) {
  constexpr int BT = C::BT, STAGES = C::STAGES, THREADS = C::THREADS;
  extern __shared__ __align__(128) float smem[];
  const int SA = xq_stride(KD);
  float* ring = smem;                // STAGES x [hi, lo][64 x KS] slices
  float* sums = ring + STAGES * 2 * SLICE;  // [32][THREADS] running sums
  float* xq = sums + 32 * THREADS;   // [BT][SA] the block's [x^2, x, 1]
  // full[s]: stage s landed; empty[s]: every warp is done reading it
  const uint32_t full = smem_addr(xq + BT * SA), empty = full + 8 * STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * BT;
  const int s0 = blockIdx.y * BS;
  const int nq = KD / KS;            // k-slices per slot
  const int total = K * nq;

  // a stage is one contiguous run of the table, the slice's hi and lo
  // parts each as it lies in shared memory (core matrix (n / 8, c) holds
  // row n's k-vector c at row n % 8): one bulk copy, issued by thread 0
  const float* wt = w + (size_t)blockIdx.y * nq * 2 * SLICE;
  const size_t slot_step = (size_t)(Spp / BS) * nq * 2 * SLICE;
  const uint32_t ring_addr = smem_addr(ring);
  auto load = [&](int it) {
    const int st = it % STAGES, k = it / nq, q = it - k * nq;
    bulk_load(ring_addr + st * 2 * SLICE * 4,
              wt + k * slot_step + (size_t)q * 2 * SLICE, 2 * SLICE * 4,
              full + 8 * st);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < STAGES && s < total; ++s) load(s);
  }

  // the xq tile, zero past T: the block's rows of x are one contiguous
  // run, read coalesced with several loads in flight per thread
  const float* xt = x + (size_t)t0 * D;
  const int nx = min(BT, T - t0) * D;
#pragma unroll 4
  for (int i = tid; i < BT * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const float v = i < nx ? __ldg(xt + i) : 0.f;
    xq[r * SA + d] = v * v;
    xq[r * SA + D + d] = v;
  }
  const int nc = KD - 2 * D;  // the constant-one column, then zeros
  for (int i = tid; i < BT * nc; i += THREADS) {
    const int r = i / nc, d = i - r * nc;
    xq[r * SA + 2 * D + d] = d == 0 && t0 + r < T ? 1.f : 0.f;
  }

  // warp w of warpgroup g owns frames 64 g + 16 (w % 4) .. + 15
  const float* sa =
      xq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SA +
      (lane >> 4) * 4;
  __syncthreads();  // xq built
  float acc[32], m[32];
  float* sum = sums + tid;           // sum i of this thread: sum[i * THREADS]
  for (int it = 0; it < total; ++it) {
    const int st = it % STAGES;
    // thread 0 refills the stage of slice it - 1 once every warp is done
    // with it: a lag of one slice, so it seldom waits for the others
    const int r = it - 1;
    if (tid == 0 && r >= 0 && r + STAGES < total) {
      mbar_wait(empty + 8 * (r % STAGES), (r / STAGES) & 1);
      load(r + STAGES);
    }
    mbar_wait(full + 8 * st, (it / STAGES) & 1);   // slice `it` landed

    const int k = it / nq, q = it - k * nq;
    uint32_t ah[KS / 8][4], al[KS / 8][4];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      ldsm_x4(ah[j], sa + q * KS + j * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = __uint_as_float(ah[j][e]);
        ah[j][e] = tf32(v);
        al[j][e] = tf32(v - __uint_as_float(ah[j][e]));
      }
    }
    const uint32_t bh = ring_addr + st * 2 * SLICE * 4;
    const uint32_t bl = bh + SLICE * 4;
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      // a k-step is 2 core matrices of k: 256 bytes on
      wgmma_tf32(acc, al[j], b_desc(bh + j * 256), q > 0 || j > 0);
      wgmma_tf32(acc, ah[j], b_desc(bl + j * 256), 1);
      wgmma_tf32(acc, ah[j], b_desc(bh + j * 256), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if (lane == 0) mbar_arrive(empty + 8 * st);    // this warp is done
    if (q != nq - 1) continue;
    // slot k done: fold e_k into the running max and sum
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ek = acc[i];
      if (k == 0) {
        m[i] = ek;
        sum[i * THREADS] = 1.f;
      } else {
        const float d = ek - m[i];
        const float u = __expf(-fabsf(d));
        const bool up = d > 0.f;
        const float s = sum[i * THREADS];
        sum[i * THREADS] = up ? fmaf(s, u, 1.f) : s + u;
        m[i] = up ? ek : m[i];
      }
    }
  }

  // accumulator 4 j + e: frame g + 8 (e / 2), state 8 j + 2 c + e % 2 of
  // the warp's 16 x 64 tile
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + warp * 16 + g + 8 * h;
    if (t >= T) continue;
    float* row = out + (size_t)t * Spp + s0 + 2 * c;
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // fully padded state columns: every slab is ~LOG_ZERO, stay there
        const float mm = m[4 * j + 2 * h + e];
        v[e] = mm <= LOG_ZERO / 2
                   ? LOG_ZERO
                   : mm + logf(sum[(4 * j + 2 * h + e) * THREADS]);
      }
      __stcs(reinterpret_cast<float2*>(row + j * 8), make_float2(v[0], v[1]));
    }
  }
}

template <class C>
int launch(const float* x, const float* w, float* out, int T, int D, int K,
           int KD, int Spp, cudaStream_t stream) {
  // once per process: allow the full shared memory, and prefer it over L1
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gmm_state_ll_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gmm_state_ll_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  if (KD % KS || Spp % BS || smem_bytes<C>(KD) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((T + C::BT - 1) / C::BT, Spp / BS);
  gmm_state_ll_kernel<C><<<grid, C::THREADS, smem_bytes<C>(KD), stream>>>(
      x, w, out, T, D, K, KD, Spp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, D]; slab table w [K, Spp / 64, KD / KS, 2, 64 * KS] (hi and lo
// parts of each slice, laid out as the note above; KD >= 2D+1 a multiple
// of the depth step) -> out [T, Spp].  All float32, contiguous, on the
// device.  Launches on `stream`; returns the CUDA error.
int gmm_state_ll_launch(const float* x, const float* w, float* out, int T,
                        int D, int K, int KD, int Spp, int tile,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == 0) return launch<Batch>(x, w, out, T, D, K, KD, Spp, s);
  if (tile == 1) return launch<Utt>(x, w, out, T, D, K, KD, Spp, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
