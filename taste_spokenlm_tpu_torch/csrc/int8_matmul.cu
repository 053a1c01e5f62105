// int8 weight-only products for Hopper, in the two layouts of the TPU file:
//   logits: x [M, D] bf16, w [V, D] int8 (table layout, per-row scale [V])
//           -> out[m, v] = (x[m] . w[v]) * scale[v], [M, V] f32;
//   matmul: x [M, D] bf16, w [D, N] int8 (Dense layout, per-column scale
//           [N]) -> out[m, n] = (x[m] . w[:, n]) * scale[n], [M, N] f32.
//
// Replaces ops/pallas/int8_matmul.py `logits_int8` (`_logits_kernel`) and
// `matmul_int8` (`_matmul_kernel`).  The TPU kernels stream blocks of the
// weight through VMEM, convert them to bf16 and run one MXU dot per block
// with f32 accumulation, the scale applied to the f32 result; Pallas needs
// the block to divide V (N) and halves it until it does.
//
// Bound on the H100: the bytes.  At decode (M = 1) the tied Llama head
// moves 263 MB of int8 table and scales for 0.5 GFLOP, some 79 us at
// 3.35 TB/s against well under a microsecond of arithmetic; a fused Llama
// projection moves 4-16 MB.  Each int8 x bf16 product is exact in f32, so
// the SIMT units form it with one FMA and the tensor cores buy nothing at
// M <= 8.  So both kernels read every weight byte once per row tile of x
// and keep up to 8 rows of x on chip:
//   * logits: a warp owns ROWS consecutive table rows and reads each as
//     16-byte vectors, 512 bytes a row per step (the row is contiguous in
//     D); x sits in shared memory as f32 in the order the lanes read it
//     (conflict-free float4 loads), and each row keeps MT accumulators in
//     registers, so one weight read serves every row of x.  The warp sums
//     its lanes with xor shuffles (a fixed order), scales and writes.  The
//     blocks walk the row groups with a grid stride; the ragged end of V is
//     masked, not padded;
//   * matmul: a block owns 256 columns (32 lanes x 8 consecutive columns,
//     one 8-byte load a row) and one slice of the contraction; its 8 warps
//     split the slice's rows, and their sums meet in shared memory in warp
//     order.  N = 1024-16,384 gives only 4-64 column tiles, so the
//     contraction is split over S blocks as well (the wrapper picks S to
//     fill the card), each writing an f32 partial [S, M, N]; a second pass
//     sums the partials in slice order and applies the scale.  No float
//     atomics: two calls give the same bits.  The ragged N edge is masked.
// Rows beyond 8 take further row tiles, each of which reads the weights
// again: right for the decode shapes, slow for prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = 4;             // logits: table rows a warp owns at once
constexpr int CHUNK = 32 * 16;      // logits: bytes of a row a warp reads a step
constexpr int COLS = 8;             // matmul: columns a lane owns
constexpr int TILE_N = 32 * COLS;   // matmul: columns a block owns
constexpr size_t SMEM_MAX = 200 * 1024;

__device__ __forceinline__ float byte_at(uint32_t word, int k) {
  return (float)((int32_t)(word << (24 - 8 * k)) >> 24);
}

// ---------------------------------------------------------------------------
// logits: w [V, D]
// ---------------------------------------------------------------------------

// x[m][c * CHUNK + lane * 16 + q * 4 + j] lives at float4 slot
// ((m * n_chunks + c) * 4 + q) * 32 + lane, component j.
template <int MT>
__global__ void __launch_bounds__(THREADS) logits_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int D,
    int V) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (D + CHUNK - 1) / CHUNK;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int per_m = n_chunks * CHUNK;
  for (int i = tid; i < MT * per_m; i += THREADS) {
    const int m = i / per_m, d = i % per_m;
    const int c = d / CHUNK, r = d % CHUNK;
    const int slot = ((m * n_chunks + c) * 4 + (r & 15) / 4) * 32 + r / 16;
    xs[slot * 4 + (r & 3)] =
        m < rows && d < D ? __bfloat162float(x[(long long)(m0 + m) * D + d])
                          : 0.f;
  }
  __syncthreads();

  const int groups = (V + WARPS * ROWS - 1) / (WARPS * ROWS);
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int v0 = (g * WARPS + warp) * ROWS;
    float acc[ROWS][MT];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int off = c * CHUNK + lane * 16;
      if (off >= D) break;           // D % 16 == 0: a lane reads all or none
      uint4 wv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        wv[r] = v0 + r < V ? __ldg(reinterpret_cast<const uint4*>(
                                 w + (long long)(v0 + r) * D + off))
                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 xv = xs4[((m * n_chunks + c) * 4 + q) * 32 + lane];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const uint32_t word = q == 0   ? wv[r].x
                                  : q == 1 ? wv[r].y
                                  : q == 2 ? wv[r].z
                                           : wv[r].w;
            acc[r][m] = fmaf(xv.x, byte_at(word, 0), acc[r][m]);
            acc[r][m] = fmaf(xv.y, byte_at(word, 1), acc[r][m]);
            acc[r][m] = fmaf(xv.z, byte_at(word, 2), acc[r][m]);
            acc[r][m] = fmaf(xv.w, byte_at(word, 3), acc[r][m]);
          }
        }
      }
    }
    // xor butterfly: every lane ends with the same sum, in a fixed order
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], o);
    // ROWS * MT <= 32: lane r * MT + m writes (r, m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (lane == r * MT + m && m < rows && v0 + r < V)
          out[(long long)(m0 + m) * V + v0 + r] = acc[r][m] * scale[v0 + r];
  }
}

template <int MT>
int launch_logits(const void* x, const void* w, const void* scale, void* out,
                  int M, int D, int V, cudaStream_t s) {
  const size_t smem = sizeof(float) * MT * (size_t)((D + CHUNK - 1) / CHUNK) * CHUNK;
  auto kern = logits_kernel<MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                         smem)) != cudaSuccess)
    return (int)e;
  const int groups = (V + WARPS * ROWS - 1) / (WARPS * ROWS);
  dim3 grid(std::min(groups, std::max(per_sm, 1) * n_sm), (M + MT - 1) / MT);
  kern<<<grid, THREADS, smem, s>>>((const __nv_bfloat16*)x, (const int8_t*)w,
                                   (const float*)scale, (float*)out, M, D, V);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matmul: w [D, N]
// ---------------------------------------------------------------------------

struct MatArgs {
  const __nv_bfloat16* x;   // [M, D]
  const int8_t* w;          // [D, N]
  const float* scale;       // [N]
  float* part;              // [S, M, N] (S > 1)
  float* out;               // [M, N]
  int M, D, N, DS, S;       // DS: contraction rows a slice
};

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS) matmul_pass1(MatArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;                    // [MT][DS]
  float* red = smem + MT * a.DS;       // [WARPS][MT][TILE_N]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.y, m0 = blockIdx.z * MT;
  const int rows = min(MT, a.M - m0);
  const int d0 = s * a.DS, d1 = min(a.D, d0 + a.DS);
  for (int i = tid; i < MT * a.DS; i += THREADS) {
    const int m = i / a.DS, d = d0 + i % a.DS;
    xs[i] = m < rows && d < d1
                ? __bfloat162float(a.x[(long long)(m0 + m) * a.D + d])
                : 0.f;
  }
  __syncthreads();

  const int n0 = blockIdx.x * TILE_N + lane * COLS;
  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;
#pragma unroll 4
  for (int d = d0 + warp; d < d1; d += WARPS) {
    const int8_t* row = a.w + (long long)d * a.N + n0;
    float wf[COLS];
    if (VEC) {
      uint2 raw = make_uint2(0u, 0u);
      if (n0 < a.N) raw = __ldg(reinterpret_cast<const uint2*>(row));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wf[c] = byte_at(raw.x, c);
        wf[4 + c] = byte_at(raw.y, c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        wf[c] = n0 + c < a.N ? (float)__ldg(row + c) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float xv = xs[m * a.DS + d - d0];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
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
    if (m >= rows || n >= a.N) continue;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) sum += red[(wi * MT + m) * TILE_N + col];
    if (a.S == 1)
      a.out[(long long)(m0 + m) * a.N + n] = sum * a.scale[n];
    else
      a.part[((long long)s * a.M + m0 + m) * a.N + n] = sum;
  }
}

__global__ void matmul_pass2(MatArgs a) {
  const long long mn = (long long)a.M * a.N;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < a.S; ++s) sum += a.part[s * mn + i];
  a.out[i] = sum * a.scale[i % a.N];
}

template <int MT, bool VEC>
int launch_matmul(const MatArgs& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)MT * a.DS + (size_t)WARPS * MT * TILE_N);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = matmul_pass1<MT, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.N + TILE_N - 1) / TILE_N, a.S, (a.M + MT - 1) / MT);
  kern<<<grid, THREADS, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || a.S == 1) return (int)e;
  const long long mn = (long long)a.M * a.N;
  matmul_pass2<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool VEC>
int run_matmul(const MatArgs& a, cudaStream_t st) {
  if (a.M == 1) return launch_matmul<1, VEC>(a, st);
  if (a.M == 2) return launch_matmul<2, VEC>(a, st);
  if (a.M <= 4) return launch_matmul<4, VEC>(a, st);
  return launch_matmul<8, VEC>(a, st);    // row tiles of 8
}

}  // namespace

// x [M, D] bf16, w [V, D] int8, scale [V] f32, out [M, V] f32; all
// contiguous.  Needs D % 16 == 0 and w 16-byte aligned.  Row tiles of 8
// (fewer where M < 8, or where 8 rows of x do not fit in shared memory).
extern "C" int tsk_logits_int8(const void* x, const void* w, const void* scale,
                               void* out, int M, int D, int V, void* stream) {
  if (D <= 0 || D % 16 || M <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t per_row = sizeof(float) * (size_t)((D + CHUNK - 1) / CHUNK) * CHUNK;
  if (per_row > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int mt = M > 4 ? 8 : M > 2 ? 4 : M;
  while (mt > 1 && mt * per_row > SMEM_MAX) mt /= 2;
  if (mt == 1) return launch_logits<1>(x, w, scale, out, M, D, V, s);
  if (mt == 2) return launch_logits<2>(x, w, scale, out, M, D, V, s);
  if (mt == 4) return launch_logits<4>(x, w, scale, out, M, D, V, s);
  return launch_logits<8>(x, w, scale, out, M, D, V, s);
}

// x [M, D] bf16, w [D, N] int8, scale [N] f32, part [S, M, N] f32 scratch
// with S = ceil(D / rows_per_split) (unused when S == 1), out [M, N] f32;
// all contiguous.  vec: N % 8 == 0 and w 8-byte aligned.  M <= 8 takes one
// row tile; more rows take tiles of 8.
extern "C" int tsk_matmul_int8(const void* x, const void* w, const void* scale,
                               void* part, void* out, int M, int D, int N,
                               int rows_per_split, int vec, void* stream) {
  if (M <= 0 || D <= 0 || N <= 0 || rows_per_split <= 0)
    return (int)cudaErrorInvalidValue;
  MatArgs a{};
  a.x = (const __nv_bfloat16*)x;
  a.w = (const int8_t*)w;
  a.scale = (const float*)scale;
  a.part = (float*)part;
  a.out = (float*)out;
  a.M = M; a.D = D; a.N = N; a.DS = rows_per_split;
  a.S = (D + rows_per_split - 1) / rows_per_split;
  cudaStream_t st = (cudaStream_t)stream;
  return vec ? run_matmul<true>(a, st) : run_matmul<false>(a, st);
}
