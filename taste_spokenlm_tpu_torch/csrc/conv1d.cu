// Same-padding dilated conv1d for Hopper, channels-last, bf16.
//
// Replaces ops/pallas/conv1d.py `conv1d_same` (kernel `_kernel`):
// y[b, t, co] = sum_k sum_ci x[b, t + k*D - pad, ci] * w[k, ci, co],
// pad = (K-1)*D/2, zero outside [0, T), summed in f32 and cast to bf16
// once; then, as JAX adds it outside its kernel, y = bf16(float(y) +
// float(bias)).  x [B, T, Cin], w [K, Cin, Cout], bias [Cout] (or none),
// y [B, T, Cout].
//
// Bound on the H100: operations.  At the HiFT ResBlock shapes (T = 7232 x
// 256 channels, T = 57857 x 128, K in {3, 7, 11}) each output does K*Cin
// multiply-adds against 2*(Cin+Cout) bytes moved, 0.9-21 GFLOP a call.
// The conv is a GEMM [T, K*Cin] @ [K*Cin, Cout] whose A operand is never
// formed: tap k reads the x rows shifted by k*D.  So:
//   * a CTA owns BM time rows and BN output channels: 256 x 128 (8 warps
//     of 64 x 64) where those tiles fill the card, else 128 x 64 (4 warps
//     of 64 x 32); the accumulators stay in registers across every tap and
//     channel, and each CTA reads the weights once, so a larger BM reads
//     them fewer times in all;
//   * per chunk of BKC input channels (32 or 64) the CTA stages the halo'd
//     x rows [t0 - pad, t0 + BM + pad) once, zero-filled outside [0, T),
//     and reads all K taps from it: the A fragment of tap k is an ldmatrix
//     at a row offset of k*D.  Rows are BKC + 8 channels (5 or 9 16-byte
//     units, an odd count), so the eight rows of an 8x8 ldmatrix land on
//     eight distinct 16-byte bank groups at any shift;
//   * the pipeline steps over (chunk, tap) pairs: each step takes one
//     [BKC, BN] weight tile (rows padded to an odd number of 16-byte units
//     for ldmatrix.trans) through a ring of S = 4 slots (3 at K = 1), each
//     filled by cp.async S - 1 steps before it is read, and a chunk's
//     first step also its x tile, in one of two slots.  One barrier a
//     step; the fragments of each k16 step are loaded while the previous
//     one's products run, the next step's first ones across the barrier;
//   * products are mma.sync.m16n8k16 bf16 -> f32 (wgmma's shared-memory A
//     operand cannot take the arbitrary row shift of a tap);
//   * the epilogue rounds the accumulators to bf16 into shared memory,
//     then each thread adds the bias (in f32 of the two bf16 values, one
//     rounding, as PyTorch and XLA add bf16) to 8 channels and stores 16
//     bytes.  No float atomics: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_HALO = 64;   // (K-1)*D

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  const bf16* bias;   // or nullptr
  bf16* y;
  int T, Cin, Cout, K, D;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, or zeros when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 y values plus two bf16 biases, each sum in f32, rounded once
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t y, uint32_t b) {
  const float2 fy = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&y));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  return pack_bf16(fy.x + fb.x, fy.y + fb.y);
}

// A CTA tile of BM rows x BN channels over WM x WN warps, BKC input
// channels a chunk, S weight tiles in the ring
template <int BM, int BN, int WM, int WN, int BKC, int S>
struct Tile {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // a warp's tile
  static constexpr int MI = WTM / 16, NJ = WTN / 8;    // its mma tiles
  static constexpr int KK = BKC / 16;                  // k16 steps a chunk
  static constexpr int LDX = BKC + 8;   // x row: 80 or 144 bytes
  static constexpr int LDW = BN + 8;    // weight row: BN / 8 + 1 units
  static constexpr int W_ELEMS = BKC * LDW;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && KK % 2 == 0, "tile");
  static_assert(BKC * (BN / 8) % THREADS == 0, "weight tile copy");
  // bytes: S weight tiles and two x tiles of BM + halo rows, or the
  // epilogue's bf16 [BM][LDW] tile, whichever is larger
  static constexpr int smem(int halo) {
    return 2 * (S * W_ELEMS + 2 * (BM + halo) * LDX) > 2 * BM * LDW
               ? 2 * (S * W_ELEMS + 2 * (BM + halo) * LDX)
               : 2 * BM * LDW;
  }
};

template <int BM, int BN, int WM, int WN, int BKC, int S>
__global__ void __launch_bounds__(32 * WM * WN) conv1d_kernel(ConvArgs p) {
  using TL = Tile<BM, BN, WM, WN, BKC, S>;
  constexpr int THREADS = TL::THREADS, LDX = TL::LDX, LDW = TL::LDW;
  constexpr int MI = TL::MI, NJ = TL::NJ, KK = TL::KK;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);   // [S][BKC][LDW]
  bf16* Xs = Ws + S * TL::W_ELEMS;                // [2][BM + halo][LDX]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int halo = (p.K - 1) * p.D, pad = halo / 2, xrows = BM + halo;
  const int x_elems = xrows * LDX;
  const bf16* xb = p.x + (long long)b * p.T * p.Cin;
  const int n_steps = (p.Cin / BKC) * p.K;

  // the producer walks the steps (chunk lc, tap lk): step ls's weight tile
  // w[lk, lc*BKC.., n0..] into ring slot ls % S, and at lk = 0 the chunk's
  // halo'd x rows into x slot lc % 2.  One commit group a step.
  int ls = 0, lc = 0, lk = 0;
  auto load_next = [&]() {
    if (ls < n_steps) {
      const int c0 = lc * BKC;
      if (lk == 0) {
        bf16* xs = Xs + (lc & 1) * x_elems;
        for (int i = tid; i < xrows * (BKC / 8); i += THREADS) {
          const int r = i / (BKC / 8), c8 = (i % (BKC / 8)) * 8;
          const int t = t0 - pad + r;
          const bool in = t >= 0 && t < p.T;
          cp_async16(xs + r * LDX + c8,
                     xb + (long long)(in ? t : 0) * p.Cin + c0 + c8, in);
        }
      }
      bf16* ws = Ws + (ls % S) * TL::W_ELEMS;
      const bf16* wg = p.w + ((long long)lk * p.Cin + c0) * p.Cout + n0;
#pragma unroll
      for (int q = 0; q < BKC * (BN / 8) / THREADS; ++q) {
        const int i = tid + q * THREADS, r = i / (BN / 8), c8 = (i % (BN / 8)) * 8;
        cp_async16(ws + r * LDW + c8, wg + (long long)r * p.Cout + c8, true);
      }
    }
    cp_commit();
    ++ls;
    if (++lk == p.K) {
      lk = 0;
      ++lc;
    }
  };

  // the fragments of k16 step kk of the current step: A is the x tile
  // shifted by the tap's k*D rows, B the weight tile
  uint32_t af[2][MI][4], bfr[2][NJ][2];
  auto frags = [&](int buf, const bf16* xa, const bf16* wb, int kk) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
      ldsm_x4(af[buf][i],
              xa + (i * 16 + (lane & 15)) * LDX + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t t[4];
      ldsm_x4_trans(t, wb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW +
                           (j + (lane >> 4)) * 8);
      bfr[buf][j][0] = t[0];
      bfr[buf][j][1] = t[1];
      bfr[buf][j + 1][0] = t[2];
      bfr[buf][j + 1][1] = t[3];
    }
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Step s's fragments are loaded one k16 step ahead of its products, the
  // next step's first ones across the barrier.  At the barrier of step s
  // (before its last products) every warp holds all of step s's fragments,
  // so the ring slot of step s - 1 and the x slot of chunk c - 1 are free:
  // the producer then issues step s + S - 1.  Its x slot held chunk
  // (s + S - 1) / K - 2, whose last step is at most s when S <= K + 2.
  for (int i = 0; i < S - 1; ++i) load_next();
  cp_wait<S - 2>();          // step 0 has landed
  __syncthreads();
  int c = 0, k = 0;
  const bf16* xa = Xs + wm * TL::WTM * LDX;
  const bf16* wb = Ws + wn * TL::WTN;
  frags(0, xa, wb, 0);
  for (int s = 0; s < n_steps; ++s) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      if (kk < KK - 1) {
        frags((kk + 1) & 1, xa, wb, kk + 1);
      } else {
        cp_wait<S - 3>();    // step s + 1 has landed
        __syncthreads();
        load_next();
        if (++k == p.K) {
          k = 0;
          ++c;
        }
        xa = Xs + (c & 1) * x_elems + (k * p.D + wm * TL::WTM) * LDX;
        wb = Ws + ((s + 1) % S) * TL::W_ELEMS + wn * TL::WTN;
        if (s + 1 < n_steps) frags(0, xa, wb, 0);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[i][j], af[kk & 1][i], bfr[kk & 1][j][0],
                   bfr[kk & 1][j][1]);
    }
  }

  // epilogue: lane (g, t4) holds rows g, g + 8 and channels 2 t4, +1 of
  // each 16 x 8 accumulator tile; round to bf16 into a [BM][LDW] tile
  cp_wait<0>();
  __syncthreads();
  bf16* Ys = Ws;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = wm * TL::WTM + i * 16 + g, col = wn * TL::WTN + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(Ys + r * LDW + col) =
          pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(Ys + (r + 8) * LDW + col) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  bf16* yb = p.y + (long long)b * p.T * p.Cout + n0;
  for (int i = tid; i < BM * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8), c8 = (i % (BN / 8)) * 8, t = t0 + r;
    if (t >= p.T) break;     // i only grows, and with it r
    uint4 v = *reinterpret_cast<const uint4*>(Ys + r * LDW + c8);
    if (p.bias != nullptr) {
      const uint4 bv = __ldg(reinterpret_cast<const uint4*>(p.bias + n0 + c8));
      v.x = add_bf16x2(v.x, bv.x);
      v.y = add_bf16x2(v.y, bv.y);
      v.z = add_bf16x2(v.z, bv.z);
      v.w = add_bf16x2(v.w, bv.w);
    }
    *reinterpret_cast<uint4*>(yb + (long long)t * p.Cout + c8) = v;
  }
}

template <int BM, int BN, int WM, int WN, int BKC, int S>
int launch(const ConvArgs& p, int B, cudaStream_t s) {
  using TL = Tile<BM, BN, WM, WN, BKC, S>;
  const int halo = (p.K - 1) * p.D;
  if (p.Cout % BN || p.Cin % BKC || S > p.K + 2)
    return (int)cudaErrorInvalidValue;
  auto kern = conv1d_kernel<BM, BN, WM, WN, BKC, S>;
  // the shared-memory limit (at the largest halo) is set once per
  // instance and device
  static bool ready[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::smem(MAX_HALO));
    if (e != cudaSuccess) return (int)e;
    ready[device] = true;
  }
  dim3 grid((p.T + BM - 1) / BM, p.Cout / BN, B);
  kern<<<grid, TL::THREADS, TL::smem(halo), s>>>(p);
  return (int)cudaGetLastError();
}

// a ring of 4 weight tiles, or 3 at K = 1, where 4 would refill an x slot
// still being read (S <= K + 2)
template <int BM, int BN, int WM, int WN, int BKC>
int launch_ring(const ConvArgs& p, int B, cudaStream_t s) {
  return p.K >= 2 ? launch<BM, BN, WM, WN, BKC, 4>(p, B, s)
                  : launch<BM, BN, WM, WN, BKC, 3>(p, B, s);
}

}  // namespace

// x [B, T, Cin], w [K, Cin, Cout], bias [Cout] or null, y [B, T, Cout];
// bf16, contiguous, 16-byte aligned.  Needs even (K-1)*D <= 64, Cin and
// Cout multiples of the tile's chunk and BN.  tile (kernels/conv1d.py
// TILES): 0 = 256 rows x 128 channels, 8 warps, 32-channel chunks; 1 =
// 128 x 64, 4 warps, 64-channel chunks; 2 = 128 x 64, 4 warps, 32-channel
// chunks.
extern "C" int tsk_conv1d_same(const void* x, const void* w, const void* bias,
                               void* y, int B, int T, int Cin, int Cout, int K,
                               int D, int tile, void* stream) {
  const int halo = (K - 1) * D;
  if (B <= 0 || T <= 0 || K <= 0 || D <= 0 || Cin <= 0 || halo % 2 ||
      halo > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  ConvArgs p{(const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)y,
             T, Cin, Cout, K, D};
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0: return launch_ring<256, 128, 4, 2, 32>(p, B, s);
    case 1: return launch_ring<128, 64, 2, 2, 64>(p, B, s);
    case 2: return launch_ring<128, 64, 2, 2, 32>(p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
