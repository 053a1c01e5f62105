// Fused DiT (U-Net BasicTransformerBlock) for Hopper, bf16.
//
// Replaces ops/pallas/fused_dit.py `fused_dit_block` (kernel `_kernel`).
// The TPU kernel holds one batch row's whole block in VMEM, including a
// [Tp, Tp] f32 score tensor per head; that does not fit a Hopper SM's
// 227 KB of shared memory, so the block is a chain of five launches, each
// keeping its intermediates out of device memory where it can:
//   1. LN1 (flax fast variance) on load + x @ [Wq|Wk|Wv]      -> qkv  bf16
//   2. masked attention, two-pass softmax (attention_core.cuh) -> a    bf16
//   3. a @ Wo + bo, cast, + x                                -> x1   bf16
//   4. LN3 on load + x1 @ W1 + b1, Abramowitz-Stegun GELU     -> f    bf16
//   5. f @ W2 + b2, cast, + x1                               -> out  bf16
// The products run on the tensor cores through WMMA (bf16 operands, f32
// accumulate); every cast to bf16 sits where the Pallas kernel casts.
// At the flow's shapes (2 x 904 x 256) the block is bound by operations:
// the SIMT f32 attention dominates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "attention_core.cuh"

using namespace nvcuda;
using namespace tsk;

namespace {

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;

enum Epi { EPI_CAST = 0, EPI_BIAS_RESID = 1, EPI_BIAS_GELU = 2 };

struct GemmArgs {
  const bf16* A;      // [M, K]
  const bf16* W[3];   // each [K, n_per_w], row-major
  int n_per_w;
  int M, N, K;
  const bf16* bias;   // [N] (EPI_BIAS_*)
  const bf16* ln_g;   // [K] (LN prologue)
  const bf16* ln_b;
  const bf16* R;      // [M, N] residual (EPI_BIAS_RESID)
  bf16* Y;            // [M, N]
};

__device__ __forceinline__ float norm_cdf_as(float x) {
  // 0.5 * (1 + erf(x / sqrt(2))), erf by Abramowitz-Stegun 7.1.26
  const float z = x * 0.70710678118654752f;
  const float a = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_abs = 1.f - poly * expf(-a * a);
  const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  return 0.5f * (1.f + sgn * erf_abs);
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs g) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  __shared__ float mu_s[BM], rstd_s[BM];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const bf16* W = g.W[n0 / g.n_per_w];
  const int wcol = n0 % g.n_per_w;

  if (LN) {
    // flax LayerNorm stats: f32 mean and E[x^2] - mean^2 clamped at 0
    const int r = tid >> 2, part = tid & 3, row = m0 + r;
    float s = 0.f, ss = 0.f;
    if (row < g.M) {
      const bf16* a = g.A + (long long)row * g.K;
      for (int e = part; e < g.K; e += 4) {
        const float x = __bfloat162float(a[e]);
        s += x;
        ss += x * x;
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    if (part == 0) {
      const float mu = s / g.K;
      const float var = fmaxf(ss / g.K - mu * mu, 0.f);
      mu_s[r] = mu;
      rstd_s[r] = 1.f / sqrtf(var + 1e-5f);
    }
    __syncthreads();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf[2];
  wmma::fill_fragment(cf[0], 0.f);
  wmma::fill_fragment(cf[1], 0.f);

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    {  // A tile: 32 rows x 32 cols, one 8-wide chunk per thread
      const int r = tid >> 2, c8 = (tid & 3) * 8, row = m0 + r;
      bf16* dst = As + r * LDA + c8;
      if (row < g.M) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(g.A + (long long)row * g.K + k0 + c8);
        if (LN) {
          const bf16* xv = reinterpret_cast<const bf16*>(&raw);
          const float mu = mu_s[r], rs = rstd_s[r];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float x = __bfloat162float(xv[e]);
            const float gg = __bfloat162float(g.ln_g[k0 + c8 + e]);
            const float bb = __bfloat162float(g.ln_b[k0 + c8 + e]);
            dst[e] = __float2bfloat16((x - mu) * rs * gg + bb);
          }
        } else {
          *reinterpret_cast<uint4*>(dst) = raw;
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // B tile: 32 rows x 64 cols
      const int c = tid + h * THREADS, r = c >> 3, c8 = (c & 7) * 8;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c8) =
          *reinterpret_cast<const uint4*>(W + (long long)(k0 + r) * g.n_per_w +
                                          wcol + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + wm * 16 * LDA + kk, LDA);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Bs + kk * LDB + wn * 32 + f * 16, LDB);
        wmma::mma_sync(cf[f], af, bfr, cf[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * 32 + f * 16, cf[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, row = m0 + r, col = n0 + c;
    if (row >= g.M) continue;
    float v = Cs[r * LDC + c];
    if (EPI == EPI_BIAS_RESID) {
      v = round_to<bf16>(v + __bfloat162float(g.bias[col]));
      v += __bfloat162float(g.R[(long long)row * g.N + col]);
    } else if (EPI == EPI_BIAS_GELU) {
      v += __bfloat162float(g.bias[col]);
      v = v * norm_cdf_as(v);
    }
    g.Y[(long long)row * g.N + col] = __float2bfloat16(v);
  }
}

template <bool LN, int EPI>
int gemm(const GemmArgs& g, cudaStream_t s) {
  dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_kernel<LN, EPI><<<grid, THREADS, 0, s>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// One BasicTransformerBlock over x [B, T, C] (bf16, contiguous); weights in
// the flax layout [in, out].  qkv [B*T, 3*inner], att [B*T, inner],
// x1 [B*T, C] and ff [B*T, 4C] are scratch the caller allocates.
// Needs head_dim 64, C % 64 == 0, inner % 64 == 0, C % 32 == 0.
extern "C" int tsk_fused_dit_block(
    const void* x, const void* lengths, int B, int T, int C, int heads,
    int head_dim, const void* g1, const void* b1, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* bo,
    const void* g3, const void* b3, const void* w1, const void* bf1,
    const void* w2, const void* bf2, void* qkv, void* att, void* x1, void* ff,
    void* out, void* stream) {
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * T, inner = heads * head_dim;
  int err;

  GemmArgs g{};
  g.A = (const bf16*)x; g.M = M; g.K = C;
  g.W[0] = (const bf16*)wq; g.W[1] = (const bf16*)wk; g.W[2] = (const bf16*)wv;
  g.n_per_w = inner; g.N = 3 * inner;
  g.ln_g = (const bf16*)g1; g.ln_b = (const bf16*)b1;
  g.Y = (bf16*)qkv;
  if ((err = gemm<true, EPI_CAST>(g, s))) return err;

  AttnArgs a;
  a.q = qkv; a.k = (const bf16*)qkv + inner; a.v = (const bf16*)qkv + 2 * inner;
  a.o = att;
  a.H = heads; a.Tq = T; a.Tk = T;
  a.q_sb = a.k_sb = a.v_sb = (long long)T * 3 * inner;
  a.q_st = a.k_st = a.v_st = 3 * inner;
  a.q_sh = a.k_sh = a.v_sh = head_dim;
  a.o_sb = (long long)T * inner; a.o_st = inner; a.o_sh = head_dim;
  a.scale = 1.f / sqrtf((float)head_dim);
  a.causal = 0;
  a.lengths = (const int*)lengths;
  if ((err = launch_attention<bf16, 64, true>(a, B, s))) return err;

  g = GemmArgs{};
  g.A = (const bf16*)att; g.M = M; g.K = inner;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)wo; g.n_per_w = C; g.N = C;
  g.bias = (const bf16*)bo; g.R = (const bf16*)x; g.Y = (bf16*)x1;
  if ((err = gemm<false, EPI_BIAS_RESID>(g, s))) return err;

  g = GemmArgs{};
  g.A = (const bf16*)x1; g.M = M; g.K = C;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)w1; g.n_per_w = 4 * C; g.N = 4 * C;
  g.bias = (const bf16*)bf1; g.ln_g = (const bf16*)g3; g.ln_b = (const bf16*)b3;
  g.Y = (bf16*)ff;
  if ((err = gemm<true, EPI_BIAS_GELU>(g, s))) return err;

  g = GemmArgs{};
  g.A = (const bf16*)ff; g.M = M; g.K = 4 * C;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)w2; g.n_per_w = C; g.N = C;
  g.bias = (const bf16*)bf2; g.R = (const bf16*)x1; g.Y = (bf16*)out;
  return gemm<false, EPI_BIAS_RESID>(g, s);
}
