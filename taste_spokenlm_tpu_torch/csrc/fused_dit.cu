// Fused DiT (U-Net BasicTransformerBlock) for Hopper, bf16.
//
// Replaces ops/pallas/fused_dit.py `fused_dit_block` (kernel `_kernel`).
// The TPU kernel holds one batch row's whole block in VMEM, including a
// [Tp, Tp] f32 score tensor per head; that does not fit a Hopper SM's
// 227 KB of shared memory, so the block is a chain of five launches, each
// keeping its intermediates out of device memory where it can:
//   1. LN1 (flax fast variance) on the staged rows + x @ [Wq|Wk|Wv] -> qkv
//   2. masked attention, two-pass softmax                          -> a
//   3. a @ Wo + bo, cast, + x                                      -> x1
//   4. LN3 on the staged rows + x1 @ W1 + b1, Abramowitz-Stegun GELU -> f
//   5. f @ W2 + b2, cast, + x1                                     -> out
// (all bf16).  Every cast to bf16 sits where the Pallas kernel casts: after
// the LN, after each projection, after the normalised softmax and after
// each residual branch.
//
// Bound on the H100: operations.  At the flow's shapes (2 x 904 or 2 x 452
// rows, C = 256, 8 heads of 64, MLP 1024) the block is ~2.7 or ~7 GFLOP
// against ~1 MB of weights and activations, a few microseconds of tensor
// cores: what the chain pays is latency, so each launch keeps every SM busy
// and its loads in flight.
//
// Products: mma.sync m16n8k16, bf16 operands from ldmatrix, f32 sums
// (attention_core.cuh).
//  * GEMMs (gemm_kernel<BM, BN, BK, LN, EPI>): 4 warps in 2 x 2 on a BM x BN
//    tile; the weight tiles (and, without LN, the A tiles) stream through a
//    4-stage cp.async ring of BK-deep k slices.  With LN (K = C) the CTA
//    stages its whole A rows once, takes each row's f32 mean and E[x^2] from
//    the staged tile (a warp a block of rows, all their loads together) and
//    normalises it in place.  At 2 x 452 rows: 64 x 128 tiles for qkv
//    (N = 1536, 180 CTAs), 32 x 128 for the MLP-in (N = 1024, 232), 64 x 32
//    for the two N = 256 products (120 CTAs: 32 x 32 tiles fill the card
//    but their L2 traffic costs more than the 12 idle SMs).  The epilogue
//    works on the accumulators: bias, cast, residual or GELU, then 4-byte
//    stores.
//  * Attention (attn_kernel): one warp owns 16 query rows of one (batch,
//    head), 4 warps a CTA (64 rows), its Q fragments in registers; 64-key K
//    (and V) tiles stream through a 4-deep cp.async ring.  Pass 1
//    forms S = Q K^T and keeps the row max and sum; pass 2 forms S again,
//    p = exp(s - m) / max(l, 1e-30) rounded to bf16 straight into the A
//    operand of P V (P never leaves the registers), and the output is rounded
//    to bf16 as is.  Keys at or past lengths[b] are -1e30 before the max, as
//    in the plain version; key tiles wholly past a positive length are
//    skipped (their exp is exactly 0).
// The tiles (and 64 query rows against 16 or 32, or the keys split over a
// CTA's warps) were picked by timing the candidates on the card at both
// shapes.
#include "attention_core.cuh"

using namespace tsk;

namespace {

constexpr int THREADS = 128;       // 4 warps
constexpr int STAGES = 4;          // depth of the GEMM ring

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
  const float t = __fdividef(1.f, 1.f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_abs = 1.f - poly * __expf(-a * a);
  const float sgn = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  return 0.5f * (1.f + sgn * erf_abs);
}

template <int BM, int BN, int GBK, bool LN>
constexpr int gemm_smem_bytes(int K) {
  return (LN ? BM * (K + 8) : 0) * 2 +
         STAGES * ((LN ? 0 : BM * (GBK + 8)) + GBK * (BN + 8)) * 2;
}

template <int BM, int BN, int GBK, bool LN, int EPI>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs g) {
  constexpr int WM = BM / 2, WN = BN / 2;       // a warp's tile
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int LDW = BN + 8;
  constexpr int ASZ = LN ? 0 : BM * (GBK + 8);  // ring slot: A, then W
  constexpr int SSZ = ASZ + GBK * LDW;
  static_assert(MT >= 1 && NT % 2 == 0, "tile too small for 2 x 2 warps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = LN ? g.K + 8 : GBK + 8;
  bf16* Af = reinterpret_cast<bf16*>(smem_raw);  // LN: [BM][K + 8]
  bf16* ring = Af + (LN ? BM * lda : 0);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wi = n0 / g.n_per_w;   // which of W[0..2] (no dynamic index)
  const bf16* W = (wi == 0 ? g.W[0] : wi == 1 ? g.W[1] : g.W[2]) +
                  n0 % g.n_per_w;
  const int nk = g.K / GBK;

  auto load_a = [&](bf16* dst, int ld, int k0, int kw) {
    const int ch = kw / 8;
    for (int i = tid; i < BM * ch; i += THREADS) {
      const int r = i / ch, c = i % ch, row = m0 + r;
      const bool in = row < g.M;
      cp_async<16>(dst + r * ld + c * 8,
                   g.A + (long long)(in ? row : 0) * g.K + k0 + c * 8, in);
    }
  };
  auto load_stage = [&](int kt) {
    bf16* st = ring + (kt % STAGES) * SSZ;
    if (!LN) load_a(st, GBK + 8, kt * GBK, GBK);
    for (int i = tid; i < GBK * (BN / 8); i += THREADS) {
      const int r = i / (BN / 8), c = i % (BN / 8);
      cp_async<16>(st + ASZ + r * LDW + c * 8,
                   W + (long long)(kt * GBK + r) * g.n_per_w + c * 8, true);
    }
  };
  if (LN) load_a(Af, lda, 0, g.K);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (LN && kt == 0) {
      // flax LayerNorm of the staged rows: f32 mean and E[x^2] - mean^2
      // clamped at 0; warp w takes rows w RPW .. w RPW + RPW - 1, each lane
      // 8 columns of every 256, all rows' loads issued together
      constexpr int RPW = BM / (THREADS / 32);
      bf16* rows = Af + warp * RPW * lda;
      const float inv_k = 1.f / g.K;
      float s[RPW], ss[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = ss[i] = 0.f;
      for (int c = lane * 8; c < g.K; c += 256) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const uint4 raw = *reinterpret_cast<const uint4*>(rows + i * lda + c);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x0 = bf16_lo(w[e]), x1 = bf16_hi(w[e]);
            s[i] += x0 + x1;
            ss[i] += x0 * x0 + x1 * x1;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
          ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
        }
        const float mu = s[i] * inv_k;
        const float var = fmaxf(ss[i] * inv_k - mu * mu, 0.f);
        s[i] = mu;
        ss[i] = rsqrtf(var + 1e-5f);
      }
      for (int c = lane * 8; c < g.K; c += 256) {
        const uint4 gr = *reinterpret_cast<const uint4*>(g.ln_g + c);
        const uint4 br = *reinterpret_cast<const uint4*>(g.ln_b + c);
        const uint32_t gw[4] = {gr.x, gr.y, gr.z, gr.w};
        const uint32_t bw[4] = {br.x, br.y, br.z, br.w};
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          uint4* at = reinterpret_cast<uint4*>(rows + i * lda + c);
          const uint4 raw = *at;
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            y[e] = pack_bf16(
                (bf16_lo(w[e]) - s[i]) * ss[i] * bf16_lo(gw[e]) + bf16_lo(bw[e]),
                (bf16_hi(w[e]) - s[i]) * ss[i] * bf16_hi(gw[e]) + bf16_hi(bw[e]));
          *at = make_uint4(y[0], y[1], y[2], y[3]);
        }
      }
      __syncthreads();
    }
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
    cp_commit();
    const bf16* st = ring + (kt % STAGES) * SSZ;
    const bf16* As = LN ? Af + kt * GBK : st;
    const int ld = LN ? lda : GBK + 8;
    const bf16* Ws = st + ASZ;
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], a_rows(As, ld, wm * WM + i * 16, kk, lane));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(Ws, LDW, wn * WN + j * 8, kk, lane));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], af[i], f[0], f[1]);
          mma_bf16(acc[i][j + 1], af[i], f[2], f[3]);
        }
      }
    }
  }

  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * WM + i * 16 + gr + 8 * half;
      if (row >= g.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * t4;
        float v[2] = {acc[i][j][2 * half], acc[i][j][2 * half + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (EPI == EPI_BIAS_RESID) {
            v[e] = round_to<bf16>(v[e] + __bfloat162float(g.bias[col + e]));
            v[e] += __bfloat162float(g.R[(long long)row * g.N + col + e]);
          } else if (EPI == EPI_BIAS_GELU) {
            v[e] += __bfloat162float(g.bias[col + e]);
            v[e] = v[e] * norm_cdf_as(v[e]);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(g.Y + (long long)row * g.N + col) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

// Raises kern's dynamic shared-memory limit to smem where it is below it.
// set_to (one per kernel instance) holds the limit set on each device, so the
// attribute is set on the first launch that needs it, not on every launch.
template <typename Kern>
int allow_smem(Kern kern, int smem, int (&set_to)[64]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > set_to[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    set_to[device] = smem;
  }
  return 0;
}

template <int BM, int BN, int GBK, bool LN, int EPI>
int gemm(const GemmArgs& g, cudaStream_t s) {
  const int smem = gemm_smem_bytes<BM, BN, GBK, LN>(g.K);
  static int set_to[64] = {};
  if (const int e = allow_smem(gemm_kernel<BM, BN, GBK, LN, EPI>, smem, set_to))
    return e;
  dim3 grid(g.N / BN, (g.M + BM - 1) / BM);
  gemm_kernel<BM, BN, GBK, LN, EPI><<<grid, THREADS, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// attention, head dim 64
// ---------------------------------------------------------------------------

constexpr int HD = 64;             // head dim
constexpr int AK = 64;             // keys a tile
constexpr int LDS = HD + 8;        // bf16 row stride (144 B)

struct AttnArgs {
  const bf16* qkv;    // [B, T, 3 * inner]: q | k | v, head h at h * 64
  bf16* o;            // [B, T, inner]
  const int* lengths;
  int H, T, inner;
  float scale;
};

constexpr int AW = 4;              // attention warps, 16 query rows each
constexpr int BQ = 16 * AW;        // query rows a CTA
constexpr int AST = 4;             // depth of the K / V ring
constexpr int kAttnSmem = (BQ + 2 * AST * AK) * LDS * 2;

__global__ void __launch_bounds__(32 * AW) attn_kernel(AttnArgs a) {
  constexpr int NTH = 32 * AW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* Ks = Qs + BQ * LDS;                      // [AST][AK][LDS]
  bf16* Vs = Ks + AST * AK * LDS;                // [AST][AK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ, T = a.T;
  const long long st = 3LL * a.inner;            // row stride of qkv
  const bf16* q = a.qkv + (long long)b * T * st + h * HD;
  const bf16* k = q + a.inner;
  const bf16* v = q + 2 * a.inner;
  const int len = min(max(a.lengths[b], 0), T);
  // every tile holding a valid key; with no valid key, all T keys (each
  // -1e30, so the softmax is uniform, as in the plain version)
  const int n_tiles = ((len > 0 ? len : T) + AK - 1) / AK;

  for (int i = tid; i < BQ * (HD / 8); i += NTH) {
    const int r = i / (HD / 8), c = i % (HD / 8), row = q0 + r;
    const bool in = row < T;
    cp_async<16>(Qs + r * LDS + c * 8, q + (in ? row : 0) * st + c * 8, in);
  }
  auto load = [&](int t, bool with_v) {
    for (int i = tid; i < AK * (HD / 8); i += NTH) {
      const int r = i / (HD / 8), c = i % (HD / 8), col = t * AK + r;
      const bool in = col < T;
      const long long off = (in ? col : 0) * st + c * 8;
      cp_async<16>(Ks + ((t % AST) * AK + r) * LDS + c * 8, k + off, in);
      if (with_v)
        cp_async<16>(Vs + ((t % AST) * AK + r) * LDS + c * 8, v + off, in);
    }
  };

  const int gr = lane >> 2, t4 = lane & 3, r16 = warp * 16;
  const float sl2 = a.scale * kLog2e;   // exp(s scale) = exp2(s sl2)
  uint32_t qf[HD / 16][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // S = Q K^T of key tile t from buffer t & 1, masked: keys at or past
  // len are -1e30, keys past T (the ragged last tile) -inf (absent)
  auto scores = [&](int t, float (&s)[AK / 8][4]) {
    const bf16* Kb = Ks + (t % AST) * AK * LDS;
#pragma unroll
    for (int j = 0; j < AK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < AK / 8; j += 2) {
        uint32_t f[4];
        ldsm_x4(f, b_rows(Kb, LDS, j * 8, kk * 16, lane));
        mma_bf16(s[j], qf[kk], f[0], f[1]);
        mma_bf16(s[j + 1], qf[kk], f[2], f[3]);
      }
    if ((t + 1) * AK > len) {
#pragma unroll
      for (int j = 0; j < AK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t * AK + j * 8 + 2 * t4 + (e & 1);
          if (col >= T) s[j][e] = -INFINITY;
          else if (col >= len) s[j][e] = kNegInf;
        }
    }
  };

  // pass 1: row max and sum (each lane its part of the sum; the quad adds
  // them at the end)
  // (a ring of AST tiles: tile t + AST - 1 is loaded into the slot that
  // tile t - 1 left, once every warp is past it)
  for (int t = 0; t < AST - 1; ++t) {
    if (t < n_tiles) load(t, false);
    cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<AST - 2>();
    __syncthreads();
    if (t + AST - 1 < n_tiles) load(t + AST - 1, false);
    cp_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], a_rows(Qs, LDS, r16, kk * 16, lane));
    }
    float s[AK / 8][4];
    scores(t, s);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < AK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = __fmul_rn(mn0, sl2), ms1 = __fmul_rn(mn1, sl2);
    l0 *= fast_exp2((m0 - mn0) * sl2);
    l1 *= fast_exp2((m1 - mn1) * sl2);
#pragma unroll
    for (int j = 0; j < AK / 8; ++j) {
      l0 += fast_exp2(__fmul_rn(s[j][0], sl2) - ms0) +
            fast_exp2(__fmul_rn(s[j][1], sl2) - ms0);
      l1 += fast_exp2(__fmul_rn(s[j][2], sl2) - ms1) +
            fast_exp2(__fmul_rn(s[j][3], sl2) - ms1);
    }
    m0 = mn0;
    m1 = mn1;
  }
  cp_wait<0>();
  __syncthreads();     // pass 2 refills the ring
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const float ms0 = __fmul_rn(m0, sl2), ms1 = __fmul_rn(m1, sl2);

  // pass 2: p = exp(s - m) / l in bf16, o = p V
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int t = 0; t < AST - 1; ++t) {
    if (t < n_tiles) load(t, true);
    cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_wait<AST - 2>();
    __syncthreads();
    if (t + AST - 1 < n_tiles) load(t + AST - 1, true);
    cp_commit();
    float s[AK / 8][4];
    scores(t, s);
    const bf16* Vb = Vs + (t % AST) * AK * LDS;
#pragma unroll
    for (int kk = 0; kk < AK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* sj = s[2 * kk + half];
        p[half][0] = fast_exp2(__fmul_rn(sj[0], sl2) - ms0) * inv0;
        p[half][1] = fast_exp2(__fmul_rn(sj[1], sl2) - ms0) * inv0;
        p[half][2] = fast_exp2(__fmul_rn(sj[2], sl2) - ms1) * inv1;
        p[half][3] = fast_exp2(__fmul_rn(sj[3], sl2) - ms1) * inv1;
      }
      uint32_t pa[4];
      pack_a(pa, p[0], p[1]);
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(Vb, LDS, j * 8, kk * 16, lane));
        mma_bf16(acc[j], pa, f[0], f[1]);
        mma_bf16(acc[j + 1], pa, f[2], f[3]);
      }
    }
  }

  bf16* o = a.o + (long long)b * T * a.inner + h * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r16 + gr + 8 * half;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)row * a.inner + j * 8 +
                                         2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

int attention(const AttnArgs& a, int B, cudaStream_t s) {
  static int set_to[64] = {};
  if (const int e = allow_smem(attn_kernel, kAttnSmem, set_to)) return e;
  dim3 grid((a.T + BQ - 1) / BQ, B * a.H);
  attn_kernel<<<grid, 32 * AW, kAttnSmem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One BasicTransformerBlock over x [B, T, C] (bf16, contiguous, 16-byte
// aligned); weights in the flax layout [in, out].  scratch (bf16) holds
// qkv [B*T, 3*inner], att [B*T, inner], x1 [B*T, C] and ff [B*T, 4*C], in
// that order.
// Needs head_dim 64, C % 64 == 0, inner % 128 == 0.
extern "C" int tsk_fused_dit_block(
    const void* x, const void* lengths, int B, int T, int C, int heads,
    int head_dim, const void* g1, const void* b1,
    const void* wq, const void* wk, const void* wv, const void* wo,
    const void* bo, const void* g3, const void* b3, const void* w1,
    const void* bf1, const void* w2, const void* bf2, void* scratch,
    void* out, void* stream) {
  const int inner = heads * head_dim;
  if (head_dim != HD || C % 64 || inner % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * T;
  bf16* qkv = (bf16*)scratch;
  bf16* att = qkv + (long long)M * 3 * inner;
  bf16* x1 = att + (long long)M * inner;
  bf16* ff = x1 + (long long)M * C;
  int err;

  GemmArgs g{};
  g.A = (const bf16*)x; g.M = M; g.K = C;
  g.W[0] = (const bf16*)wq; g.W[1] = (const bf16*)wk; g.W[2] = (const bf16*)wv;
  g.n_per_w = inner; g.N = 3 * inner;
  g.ln_g = (const bf16*)g1; g.ln_b = (const bf16*)b1;
  g.Y = qkv;
  if ((err = gemm<64, 128, 64, true, EPI_CAST>(g, s))) return err;

  AttnArgs a{qkv, att, (const int*)lengths, heads, T, inner,
             1.f / sqrtf((float)head_dim)};
  err = attention(a, B, s);
  if (err) return err;

  g = GemmArgs{};
  g.A = att; g.M = M; g.K = inner;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)wo; g.n_per_w = C; g.N = C;
  g.bias = (const bf16*)bo; g.R = (const bf16*)x; g.Y = x1;
  if ((err = gemm<64, 32, 128, false, EPI_BIAS_RESID>(g, s))) return err;

  g = GemmArgs{};
  g.A = x1; g.M = M; g.K = C;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)w1; g.n_per_w = 4 * C; g.N = 4 * C;
  g.bias = (const bf16*)bf1; g.ln_g = (const bf16*)g3; g.ln_b = (const bf16*)b3;
  g.Y = ff;
  if ((err = gemm<32, 128, 64, true, EPI_BIAS_GELU>(g, s))) return err;

  g = GemmArgs{};
  g.A = ff; g.M = M; g.K = 4 * C;
  g.W[0] = g.W[1] = g.W[2] = (const bf16*)w2; g.n_per_w = C; g.N = C;
  g.bias = (const bf16*)bf2; g.R = x1; g.Y = (bf16*)out;
  return gemm<64, 32, 128, false, EPI_BIAS_RESID>(g, s);
}
