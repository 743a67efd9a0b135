// Fused MFCC core: frames -> windowed DFT -> |X| -> (log power) -> mel -> DCT.
//
// Replaces the TPU kernel `aaltoasr_tpu/ops/frontend_pallas.py` (`_kernel`,
// launched by `mfcc_core`).  Same math as `reference_core` there and
// `aaltoasr_tpu_torch/ops/frontend_cuda.py:reference_core`:
//
//   reim  = frames @ dft_basis            [T, W] @ [W, 2K]  (window folded in)
//   spec  = re^2 + im^2, or its sqrt      [T, K]
//   pw    = log(sum_k spec + 1e-10)       [T, 1]  (optional)
//   mel   = log1p(spec @ mel_w), or ^0.1  [T, M]
//   cep   = mel @ dct                     [T, C]
//
// What bounds it: the DFT product, 2*W*2K flops per frame (132k at W=256).
// Per frame it reads W*4 bytes and writes (C+1)*4, so the product, not
// device memory, sets the time.  On the float32 CUDA cores it reached
// 11 TFLOP/s, a sixth of their peak, held back by shared-memory loads.
// Here it runs on the tensor cores as 3xTF32 (mma.sync m16n8k8): every
// float32 operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi),
// and each k-step accumulates lo*hi + hi*lo + hi*hi in float32, which keeps
// the product about as close to the float64 result as float32 is (one
// TF32 pass is not: LNA codes step every 1/1820).  The wrapper splits the
// basis once; the kernel splits each frame element after its shared load.
// On an H100 (700 W) the batch tile issues the 3x work at about 120
// TFLOP/s, a quarter of the card's 495 TFLOP/s TF32 peak (which wgmma,
// not mma.sync, is built to reach).  What holds it there, by ablation:
// issuing the per-slice copies and waiting on them (a fifth of the
// time), the mel epilogue (an eighth), and the ldmatrix loads and
// operand splits around the products, with one barrier per k-slice.
//
// Design:
// * The basis comes as [Np, Wp] hi and lo arrays, transposed so a k-slice
//   of a column is contiguous, with bin k's re column at row 2k and its
//   im column at 2k+1.  An m16n8k8 accumulator then holds re and im of
//   the same bin in the same thread, and the spectrum is formed in
//   registers.  Rows past 2K are zero; the copy zero-fills them without
//   reading memory.
// * The reduction dimension W streams through shared memory in k-slices
//   of KS, for the frames as well as the basis, through a ring of STAGES
//   cp.async (16-byte) copies: the next slice loads while the tensor
//   cores work on this one, and shared memory does not grow with W (any
//   window the JAX kernel takes runs; the frames' ragged k-tail and rows
//   past T are zero-filled by the copy).
// * Columns go in chunks of NB = 96 (48 bins).  At the end of a chunk
//   the spectrum chunk goes to a [TT, 48] tile; its power sum and its mel
//   partial product accumulate per row, so the [TT, K] spectrum is never
//   held.  The mel weights come as a per-bin window of BW bands (3 for
//   the triangles), from `mel_band[k]` on.  After the last chunk: log1p
//   (or ^0.1), the DCT on the CUDA cores, and only the cepstra and the
//   power column are written to device memory.
// * Two tile shapes; the wrapper picks by T.  TT=128 (8 warps, 2 blocks
//   per SM) for batches: the hi/lo basis (590 KB at W=256) is streamed
//   once per 128 frames.  TT=16 (6 warps) for one utterance (~1,000
//   frames): 63 blocks instead of 8, since a launch that does not fill
//   the card is bound by the latency of one block's slice loop, not by
//   the bytes streamed.  The batch tile takes over at about 8,000
//   frames, where it fills half the SMs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NB = 96;             // basis columns per chunk: 48 bins
constexpr int NBINS = NB / 2;
constexpr int SS = NBINS + 1;      // spectrum tile row stride (odd)
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use

template <int WARPS_M_, int WARPS_N_, int MT_, int NT_, int KS_, int STAGES_,
          int MINB_>
struct Tile {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int MT = MT_, NT = NT_;  // m16 / n8 tiles per warp
  static constexpr int KS = KS_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int TT = WARPS_M * MT * 16;  // frames per block
  static constexpr int SA = KS + 4;             // k-slice row stride (floats)
  static constexpr int STAGE = (TT + 2 * NB) * SA;
  static constexpr int G = THREADS / TT;        // epilogue threads per row
  static_assert(WARPS_N * NT * 8 == NB, "a chunk is NB columns");
  static_assert(THREADS % TT == 0, "whole rows per epilogue thread group");
  static_assert(KS % 8 == 0 && 32 % KS == 0, "k-slices divide 32");
};

using Batch = Tile<4, 2, 2, 6, 16, 2, 2>;  // TT = 128, 8 warps, 2 per SM
using Utt = Tile<1, 6, 1, 2, 32, 3, 1>;    // TT = 16, 6 warps

template <class C>
size_t smem_bytes(int M) {
  return sizeof(float) * ((size_t)C::STAGES * C::STAGE + (size_t)C::TT * SS +
                          (size_t)C::G * M * C::TT + (size_t)C::G * C::TT);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy; `bytes` < 16 zero-fills the rest (0: no global read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix on float32 data: an 8x8 b16 matrix is 8 rows of 4 floats, and
// thread l receives float (l & 3) of row (l >> 2), which is the tf32
// fragment layout of mma.m16n8k8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
mfcc_core_kernel(const float* __restrict__ frames,
                 const float* __restrict__ bhi, const float* __restrict__ blo,
                 const float* __restrict__ mel_tab,
                 const int* __restrict__ mel_band,
                 const float* __restrict__ dct, float* __restrict__ cep,
                 float* __restrict__ pw, int T, int Wf, int Wp, int Np, int K,
                 int M, int Cn, int BW, int magnitude, int root,
                 int with_power) {
  constexpr int TT = C::TT, SA = C::SA, KS = C::KS, STAGES = C::STAGES;
  constexpr int MT = C::MT, NT = C::NT, G = C::G, THREADS = C::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* pipe = smem;                          // STAGES x [TT + 2 NB][SA]
  float* spec = pipe + STAGES * C::STAGE;      // [TT][SS] spectrum chunk
  float* melacc = spec + TT * SS;              // [G][M][TT] mel partials
  float* pwacc = melacc + G * M * TT;          // [G][TT] power partials

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int t0 = blockIdx.x * TT;
  const int nks = (Wf + KS - 1) / KS;
  const int total = (Np / NB) * nks;
  const int nreal = (2 * K + 7) / 8 * 8;       // columns that hold bins

  for (int i = tid; i < G * M * TT; i += THREADS) melacc[i] = 0.f;

  // this thread's 16-byte copies of a slice: the same rows and vectors of
  // every slice, at k0 (and for the basis, chunk c) further on
  constexpr int V = KS / 4;                        // vectors per slice row
  constexpr int FV = TT * V, BV = 2 * NB * V;      // frame, basis vectors
  constexpr int NF = (FV + THREADS - 1) / THREADS;
  constexpr int NBV = (BV + THREADS - 1) / THREADS;
  const float* fsrc[NF];
  int fdst[NF], fk[NF];
  bool frow[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int v = tid + i * THREADS, r = v / V, q = v % V;
    frow[i] = v < FV && t0 + r < T;
    fsrc[i] = frames + (frow[i] ? (size_t)(t0 + r) * Wf + 4 * q : 0);
    fdst[i] = v < FV ? r * SA + 4 * q : -1;
    fk[i] = 4 * q;
  }
  const float* bsrc[NBV];
  int bdst[NBV], bcol[NBV];
#pragma unroll
  for (int i = 0; i < NBV; ++i) {
    const int v = tid + i * THREADS, h = v / (NB * V), u = v % (NB * V);
    const int n = u / V, q = u % V;
    bsrc[i] = (h ? blo : bhi) + (size_t)n * Wp + 4 * q;
    bdst[i] = v < BV ? (TT + h * NB + n) * SA + 4 * q : -1;
    bcol[i] = n;
  }
  auto load = [&](int it) {
    float* st = pipe + (it % STAGES) * C::STAGE;
    const int c = it / nks, k0 = (it - c * nks) * KS;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (FV % THREADS && fdst[i] < 0) continue;
      const bool ok = frow[i] && k0 + fk[i] < Wf;
      cp_async16(st + fdst[i], ok ? fsrc[i] + k0 : frames, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < NBV; ++i) {
      if (BV % THREADS && bdst[i] < 0) continue;
      const bool ok = c * NB + bcol[i] < nreal;
      cp_async16(st + bdst[i], ok ? bsrc[i] + (size_t)c * NB * Wp + k0 : bhi,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float psum = 0.f;  // power partial of epilogue row tid % TT

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice `it` landed; slot of `it - 1` is free
    if (it + STAGES - 1 < total) load(it + STAGES - 1);
    cp_async_commit();

    const int c = it / nks;
    const float* st = pipe + (it % STAGES) * C::STAGE;
    const float* sa = st + wm * MT * 16 * SA;
    const float* sbh = st + (TT + wn * NT * 8) * SA;
    const float* sbl = sbh + NB * SA;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(ah[i], sa + (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SA +
                           kk + (lane >> 4) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = __uint_as_float(ah[i][e]);
          ah[i][e] = tf32(x);
          al[i][e] = tf32(x - __uint_as_float(ah[i][e]));
        }
      }
      // each of the three products over all the warp's accumulators in
      // turn, so no mma waits on the one before.  No branch in here:
      // ldmatrix and mma are warp-collective (.aligned), and padded basis
      // columns hold zeros.
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int off = (j * 8 + (lane & 7)) * SA + kk + ((lane >> 3) & 1) * 4;
        ldsm_x2(bh[j], sbh + off);
        ldsm_x2(bl[j], sbl + off);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bh[j]);
    }

    if (it % nks != nks - 1) continue;
    // chunk c done: its spectrum, then its power and mel partials
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = wm * MT * 16 + i * 16 + (lane >> 2);
        const int bin = (wn * NT + j) * 4 + (lane & 3);
        float p0 = acc[i][j][0] * acc[i][j][0] + acc[i][j][1] * acc[i][j][1];
        float p1 = acc[i][j][2] * acc[i][j][2] + acc[i][j][3] * acc[i][j][3];
        if (magnitude) {
          p0 = sqrtf(p0);
          p1 = sqrtf(p1);
        }
        spec[row * SS + bin] = p0;
        spec[(row + 8) * SS + bin] = p1;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    __syncthreads();
    {
      const int r = tid % TT, g = tid / TT;
      const int kb = c * NBINS;
      const int nb = min(NBINS, K - kb);
      for (int j = g; j < nb; j += G) {
        const float s = spec[r * SS + j];
        psum += s;
        const int k = kb + j;
        float* ma = melacc + (g * M + __ldg(mel_band + k)) * TT + r;
        for (int q = 0; q < BW; ++q)
          ma[q * TT] = fmaf(s, __ldg(mel_tab + k * BW + q), ma[q * TT]);
      }
    }
    // the next write of `spec` follows at least one barrier of the loop
  }

  pwacc[tid] = psum;  // tid == g * TT + r
  __syncthreads();
  for (int i = tid; i < M * TT; i += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) a += melacc[g * M * TT + i];
    melacc[i] = root ? powf(a, 0.1f) : log1pf(a);
  }
  if (with_power && tid < TT) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) s += pwacc[g * TT + tid];
    const int t = t0 + tid;
    if (t < T) pw[t] = logf(s + 1e-10f);
  }
  __syncthreads();
  for (int i = tid; i < TT * Cn; i += THREADS) {
    const int r = i / Cn, cc = i - r * Cn;
    const int t = t0 + r;
    if (t >= T) continue;
    float a = 0.f;
    for (int m = 0; m < M; ++m)
      a = fmaf(melacc[m * TT + r], __ldg(dct + m * Cn + cc), a);
    cep[(size_t)t * Cn + cc] = a;
  }
}

template <class C>
int launch(const float* frames, const float* bhi, const float* blo,
           const float* mel_tab, const int* mel_band, const float* dct,
           float* cep, float* pw, int T, int Wf, int Wp, int Np, int K, int M,
           int Cn, int BW, int magnitude, int root, int with_power,
           cudaStream_t stream) {
  // once per process: allow the full shared memory, and prefer it over L1
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        mfcc_core_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mfcc_core_kernel<C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = (T + C::TT - 1) / C::TT;
  mfcc_core_kernel<C><<<blocks, C::THREADS, smem_bytes<C>(M), stream>>>(
      frames, bhi, blo, mel_tab, mel_band, dct, cep, pw, T, Wf, Wp, Np, K, M,
      Cn, BW, magnitude, root, with_power);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Basis columns per chunk: the wrapper pads the basis rows to a multiple.
int mfcc_core_chunk_columns() { return NB; }

// Dynamic shared memory of one block of the `tile`-frame shape, in bytes
// (0 for a shape the library does not have).
size_t mfcc_core_smem_bytes(int tile, int M) {
  if (tile == Batch::TT) return smem_bytes<Batch>(M);
  if (tile == Utt::TT) return smem_bytes<Utt>(M);
  return 0;
}

// frames [T, Wf] (Wf a multiple of 4, 16-byte aligned), basis hi and lo
// [Np, Wp] (Np a multiple of NB, Wp of 32, laid out as the note above),
// mel_tab [Np/2, BW] with mel_band [Np/2], dct [M, C] -> cep [T, C] and,
// when with_power, pw [T] (pw may be null otherwise).  All float32 but
// mel_band (int32), contiguous, on the device.  `tile` is 128 or 16
// frames per block.  Launches on `stream`; returns the CUDA error.
int mfcc_core_launch(const float* frames, const float* bhi, const float* blo,
                     const float* mel_tab, const int* mel_band,
                     const float* dct, float* cep, float* pw, int T, int Wf,
                     int Wp, int Np, int K, int M, int C, int BW,
                     int magnitude, int root, int with_power, int tile,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile == Batch::TT)
    return launch<Batch>(frames, bhi, blo, mel_tab, mel_band, dct, cep, pw, T,
                         Wf, Wp, Np, K, M, C, BW, magnitude, root, with_power,
                         s);
  if (tile == Utt::TT)
    return launch<Utt>(frames, bhi, blo, mel_tab, mel_band, dct, cep, pw, T,
                       Wf, Wp, Np, K, M, C, BW, magnitude, root, with_power, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
