// int4 weight-only product for Hopper: x [M, D] bf16 @ dequant(w) -> [M, N]
// f32, where w is nibble-packed [D/2, N] uint8 (low nibble: logical row r,
// high nibble: row D/2 + r, both two's complement) with group-wise f32
// scales [D/group, N] (the low-half groups first).
//
// Replaces ops/pallas/int4_matmul.py `matmul_int4` (kernel `_kernel`).  The
// TPU kernel streams N tiles of the packed matrix through VMEM and runs one
// MXU dot per scale group; Pallas pads a ragged N up to the block.
//
// Bound on the H100: the bytes.  At decode (M = 1) the tied Llama head
// moves 131 MB of packed weights and 8.2 MB of scales for 0.5 GFLOP, some
// 40 us at 3.35 TB/s against well under 1 us of arithmetic.  So the design
// reads every weight byte once per row tile and nothing else:
//   * a block owns 128 columns (32 lanes x 4 consecutive columns, one
//     4-byte load per packed row when N % 4 == 0) and MT rows of x, kept in
//     shared memory as f32 (MT = 1 at decode, 8 otherwise);
//   * its 8 warps split the contraction by scale group: warp w sums groups
//     w, w + 8, ...; each thread keeps the low- and high-plane partial sums
//     of a group in registers (exact bf16 x int4 products, f32 sums), scales
//     them on the f32 accumulator, and the 8 warp sums meet in shared memory
//     in a fixed order, so the result does not change from run to run;
//   * the ragged column edge is masked, not padded.
// Rows beyond 8 take further row tiles, each of which reads the weights
// again: fine for the decode head, slow for large M, where a tensor-core
// version (wgmma on dequantized tiles) is the later step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, COLS = 4, TILE_N = 32 * COLS;

__device__ __forceinline__ float lo_nibble(uint32_t b) {
  return (float)((int32_t)(b << 28) >> 28);
}

__device__ __forceinline__ float hi_nibble(uint32_t b) {
  return (float)((int32_t)(b << 24) >> 28);
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS) int4_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const float* __restrict__ scale, float* __restrict__ out, int M, int D,
    int N, int group) {
  extern __shared__ float smem[];
  float* xs = smem;               // [MT][D]
  float* red = smem + MT * D;     // [WARPS][MT][TILE_N]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int n0 = blockIdx.x * TILE_N + lane * COLS;
  for (int i = tid; i < MT * D; i += THREADS) {
    const int m = i / D;
    xs[i] = m < rows ? __bfloat162float(x[(long long)(m0 + m) * D + i % D])
                     : 0.f;
  }
  __syncthreads();

  const int half = D / 2, n_g = half / group;
  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;

  for (int g = warp; g < n_g; g += WARPS) {
    float lo[MT][COLS], hi[MT][COLS];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < COLS; ++c) lo[m][c] = hi[m][c] = 0.f;
#pragma unroll 4
    for (int r = g * group; r < (g + 1) * group; ++r) {
      const uint8_t* row = wp + (long long)r * N + n0;
      uint32_t b[COLS];
      if (VEC) {
        uint32_t word = 0;
        if (n0 < N) word = __ldg(reinterpret_cast<const uint32_t*>(row));
#pragma unroll
        for (int c = 0; c < COLS; ++c) b[c] = (word >> (8 * c)) & 0xffu;
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) b[c] = n0 + c < N ? __ldg(row + c) : 0u;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs[m * D + r], xh = xs[m * D + half + r];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          lo[m][c] = fmaf(xl, lo_nibble(b[c]), lo[m][c]);
          hi[m][c] = fmaf(xh, hi_nibble(b[c]), hi[m][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int n = n0 + c;
      const float s_lo = n < N ? scale[(long long)g * N + n] : 0.f;
      const float s_hi = n < N ? scale[(long long)(n_g + g) * N + n] : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        acc[m][c] += lo[m][c] * s_lo + hi[m][c] * s_hi;
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      red[(warp * MT + m) * TILE_N + lane * COLS + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < MT * TILE_N; i += THREADS) {
    const int m = i / TILE_N, col = i % TILE_N;
    const int n = blockIdx.x * TILE_N + col;
    if (m >= rows || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[(w * MT + m) * TILE_N + col];
    out[(long long)(m0 + m) * N + n] = s;
  }
}

template <int MT, bool VEC>
int launch(const void* x, const void* wp, const void* scale, void* out, int M,
           int D, int N, int group, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)MT * (D + WARPS * TILE_N);
  auto kern = int4_kernel<MT, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TILE_N - 1) / TILE_N, (M + MT - 1) / MT);
  kern<<<grid, THREADS, smem, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)wp, (const float*)scale,
      (float*)out, M, D, N, group);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, D] bf16, wp [D/2, N] uint8, scale [D/group, N] f32 (group = packed
// rows per scale row), out [M, N] f32; all contiguous.  vec: N % 4 == 0 and
// wp 4-byte aligned.  Needs D even and (D/2) % group == 0.
extern "C" int tsk_matmul_int4(const void* x, const void* wp, const void* scale,
                               void* out, int M, int D, int N, int group,
                               int vec, void* stream) {
  if (D % 2 || group <= 0 || (D / 2) % group) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 1)
    return vec ? launch<1, true>(x, wp, scale, out, M, D, N, group, s)
               : launch<1, false>(x, wp, scale, out, M, D, N, group, s);
  return vec ? launch<8, true>(x, wp, scale, out, M, D, N, group, s)
             : launch<8, false>(x, wp, scale, out, M, D, N, group, s);
}
