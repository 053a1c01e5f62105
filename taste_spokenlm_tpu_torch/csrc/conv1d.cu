// Same-padding dilated conv1d for Hopper, channels-last, bf16.
//
// Replaces ops/pallas/conv1d.py `conv1d_same` (kernel `_kernel`):
// y[b, t, co] = sum_k sum_ci x[b, t + k*D - pad, ci] * w[k, ci, co],
// pad = (K-1)*D/2, zero outside [0, T).  x [B, T, Cin], w [K, Cin, Cout],
// y [B, T, Cout]; the bias is added by the caller, as in JAX.
//
// Grid (T tile of 64, Cout tile of 64, batch).  For each 32-channel slice
// of Cin the CTA stages the halo'd x rows [t0 - pad, t0 + 64 + pad) in
// shared memory once, then runs the K taps as 64x64x32 WMMA products whose
// A operand is the staged tile shifted by k*D rows; the accumulator stays
// in f32 registers across taps and channel slices.  At the HiFT shapes
// (T = 7232 x 256 ch, T = 57856 x 128 ch) the conv is bound by operations
// (K*Cin multiply-adds per output against 2*(Cin+Cout) bytes moved).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64, BN = 64, BKC = 32, THREADS = 128;
constexpr int MAX_HALO = 64;
constexpr int LDX = BKC + 16;  // 96-byte rows: any row shift stays 32B-aligned
constexpr int LDW = BN + 8;
constexpr int LDC = BN + 4;

struct ConvArgs {
  const bf16* x;
  const bf16* w;
  bf16* y;
  int T, Cin, Cout, K, D;
};

__global__ void __launch_bounds__(THREADS) conv1d_kernel(ConvArgs p) {
  __shared__ __align__(128) bf16 Xs[(BM + MAX_HALO) * LDX];
  __shared__ __align__(128) bf16 Ws[BKC * LDW];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int halo = (p.K - 1) * p.D, pad = halo / 2, rows = BM + halo;
  const bf16* xb = p.x + (long long)b * p.T * p.Cin;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(cf[i][j], 0.f);

  for (int c0 = 0; c0 < p.Cin; c0 += BKC) {
    __syncthreads();
    for (int c = tid; c < rows * (BKC / 8); c += THREADS) {
      const int r = c / (BKC / 8), c8 = (c % (BKC / 8)) * 8;
      const int t = t0 - pad + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (t >= 0 && t < p.T)
        v = *reinterpret_cast<const uint4*>(xb + (long long)t * p.Cin + c0 + c8);
      *reinterpret_cast<uint4*>(Xs + r * LDX + c8) = v;
    }
    for (int k = 0; k < p.K; ++k) {
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = tid + h * THREADS, r = c >> 3, c8 = (c & 7) * 8;
        *reinterpret_cast<uint4*>(Ws + r * LDW + c8) =
            *reinterpret_cast<const uint4*>(
                p.w + ((long long)k * p.Cin + c0 + r) * p.Cout + n0 + c8);
      }
      __syncthreads();
      const bf16* xa = Xs + (k * p.D + wm * 32) * LDX;
#pragma unroll
      for (int kk = 0; kk < BKC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], xa + i * 16 * LDX + kk, LDX);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bfr[j], Ws + kk * LDW + wn * 32 + j * 16, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(cf[i][j], af[i], bfr[j], cf[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              cf[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  bf16* yb = p.y + (long long)b * p.T * p.Cout;
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, t = t0 + r;
    if (t < p.T)
      yb[(long long)t * p.Cout + n0 + c] = __float2bfloat16(Cs[r * LDC + c]);
  }
}

}  // namespace

// x [B, T, Cin], w [K, Cin, Cout], y [B, T, Cout]; bf16, contiguous.
// Needs Cin % 32 == 0, Cout % 64 == 0, even (K-1)*D <= 64.
extern "C" int tsk_conv1d_same(const void* x, const void* w, void* y, int B,
                               int T, int Cin, int Cout, int K, int D,
                               void* stream) {
  const int halo = (K - 1) * D;
  if (Cin % BKC || Cout % BN || halo % 2 || halo > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  ConvArgs p{(const bf16*)x, (const bf16*)w, (bf16*)y, T, Cin, Cout, K, D};
  dim3 grid((T + BM - 1) / BM, Cout / BN, B);
  conv1d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
