// Attention tile kernel of fused_dit.cu (relpos_attention.cu takes its
// helpers).  flash_attention.cu has kernels of its own.
//
// One CTA of 256 threads owns a 64-row query tile of one (batch, head).
// K/V stream through shared memory in 64-key tiles, converted to f32 on
// load; every product is a true-f32 FMA (no TF32, no tensor cores), which
// is what the f32 whisper tower needs: its RVQ argmin over 512 codes flips
// on TF32-scale drift.  Thread (ty, tx) of a 16x16 grid owns rows
// ty*4..ty*4+3 and the columns tx + 16*j, so row reductions are 16-lane
// shuffles inside one half-warp.
//
// Two softmax schedules:
//  * TWO_PASS=false: online softmax in one sweep, P rounded to the input
//    type before the P.V product, output acc / max(l, 1e-30) -- the
//    numerics of ops/pallas/flash_attention.py.  No launch uses it since
//    flash_attention.cu took kernels of its own; it stays, with the rest of
//    attn_kernel, as it was.
//  * TWO_PASS=true (fused DiT): pass 1 finds the row max and sum, pass 2
//    forms p = exp(s - m) / max(l, 1e-30), rounds it to the input type and
//    accumulates p.v, output rounded -- the cast points of
//    ops/pallas/fused_dit.py, which normalises before the value product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsk {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// value after a cast to the storage type T (a bf16 cast point)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite -inf
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kAttnThreads = 256;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Tq, Tk;
  // element strides of batch, time and head; the head dim is contiguous
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  float scale;
  int causal;
  const int* lengths;  // per-batch valid key count, or nullptr for Tk
};

template <int D>
constexpr int attn_smem_bytes() {
  return (3 * kBK * (D + 1) + kBQ * (kBK + 1)) * 4;
}

template <typename T, int D, bool TWO_PASS>
__global__ void __launch_bounds__(kAttnThreads) attn_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int NJ = D / 16;
  float* Qs = smem;            // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;   // [kBK][LD]
  float* Vs = Ks + kBK * LD;   // [kBK][LD]
  float* Ps = Vs + kBK * LD;   // [kBQ][LP]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * kBQ;
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh;
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;
  int kv_len = a.Tk;
  if (a.lengths != nullptr) kv_len = min(max(a.lengths[b], 0), a.Tk);

  for (int idx = tid; idx < kBQ * D; idx += kAttnThreads) {
    const int r = idx / D, d = idx % D, row = q0 + r;
    Qs[r * LD + d] = row < a.Tq ? to_f32(q[row * a.q_st + d]) : 0.f;
  }
  int n_tiles = (a.Tk + kBK - 1) / kBK;
  if (a.causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  auto load_tile = [&](int k0, bool with_v) {
    for (int idx = tid; idx < kBK * D; idx += kAttnThreads) {
      const int r = idx / D, d = idx % D, col = k0 + r;
      const bool in = col < a.Tk;
      Ks[r * LD + d] = in ? to_f32(k[col * a.k_st + d]) : 0.f;
      if (with_v) Vs[r * LD + d] = in ? to_f32(v[col * a.v_st + d]) : 0.f;
    }
  };

  // s[i][j] = masked q_row . k_col * scale for this thread's 4x4 entries
  auto scores = [&](int k0, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < kv_len && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
      }
    }
  };

  auto row_max = [&](float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
  };
  auto row_sum = [&](float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
  };

  // acc += P . V over one tile (P in Ps)
  auto pv = [&]() {
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vb[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vb[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  };

  float s[4][4];
  if (TWO_PASS) {
    for (int t = 0; t < n_tiles; ++t) {
      __syncthreads();
      load_tile(t * kBK, false);
      __syncthreads();
      scores(t * kBK, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], row_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
        m[i] = m_new;
      }
    }
  }
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(t * kBK, true);
    __syncthreads();
    scores(t * kBK, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = Ps + (ty * 4 + i) * LP + tx;
      if (TWO_PASS) {
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          prow[16 * j] = round_to<T>(expf(s[i][j] - m[i]) * inv);
      } else {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
        const float m_new = fmaxf(m[i], row_max(mx));
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_new);
          sum += p;
          prow[16 * j] = round_to<T>(p);
        }
        l[i] = l[i] * alpha + row_sum(sum);
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      }
    }
    __syncthreads();
    pv();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Tq) continue;
    const float inv = TWO_PASS ? 1.f : 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[row * a.o_st + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

// Launch attn_kernel<T, D, TWO_PASS> on `stream`; returns cudaGetLastError().
template <typename T, int D, bool TWO_PASS>
int launch_attention(const AttnArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<D>();
  cudaFuncSetAttribute(attn_kernel<T, D, TWO_PASS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((a.Tq + kBQ - 1) / kBQ, batch * a.H);
  attn_kernel<T, D, TWO_PASS><<<grid, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace tsk
