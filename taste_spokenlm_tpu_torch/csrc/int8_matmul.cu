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
// and keep its rows on chip (logits up to 8, matmul up to 4):
//   * logits: a warp owns ROWS consecutive table rows and reads each as
//     16-byte vectors, 512 bytes a row per step (the row is contiguous in
//     D); x sits in shared memory as f32 in the order the lanes read it
//     (conflict-free float4 loads), and each row keeps MT accumulators in
//     registers, so one weight read serves every row of x.  The warp sums
//     its lanes with xor shuffles (a fixed order), scales and writes.  The
//     blocks walk the row groups with a grid stride; the ragged end of V is
//     masked, not padded;
//   * matmul (one launch for every shape): a block owns a column tile (8
//     lanes x C consecutive columns, one C-byte load of a weight row),
//     up to 4 rows of x and one slice of the contraction, which its
//     THREADS / 8 row-lanes share in contiguous runs, UNROLL rows in
//     flight a lane; their sums meet in shared memory in a fixed order.
//     An int8 becomes a float by a byte permute into the mantissa of 2^23
//     and one subtraction, not by an int-to-float conversion, which runs
//     at a fraction of the FMA rate.  The decode projections (1-32 MB)
//     take 0.3-10 us of HBM time, so the latency of a launch, a round trip
//     to memory and any cross-block sum decides them.  The wrapper's
//     `split_plan` (timed at every path shape) gives M = 1 one slice,
//     with no partial, where a lane walks at most 16 rows (D <= 1024) or
//     the column tiles of 4-byte lanes fill half the card; its lanes
//     narrow to 4 bytes until the tiles fill the card once.  Few tiles
//     over a long contraction ([2048, 1024], [2048, 2048], [8192, 2048])
//     take 16-byte lanes and 8 slices, about 8-16 rows a lane: there the
//     last block to arrive on a column tile (an integer arrival counter,
//     which that block resets to 0) adds the f32 partials in slice order
//     and scales them.  No float atomics: two calls give the same bits.
//     The counters persist between calls, so launches that share them
//     must not overlap (calls on one stream, graph replays ordered with
//     them).  The ragged N edge is masked.
// Rows of x beyond 4 take further row tiles, each of which reads the
// weights again: right for the decode shapes, slow for prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int ROWS = 4;             // logits: table rows a warp owns at once
constexpr int CHUNK = 32 * 16;      // logits: bytes of a row a warp reads a step
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

constexpr int COL_LANES = 8;    // lanes across a column tile

// C bytes of one weight row from p (columns n0.. of N) as C / 4
// little-endian words; bytes past N read as 0 (a zero weight adds nothing)
template <int C, bool VEC>
__device__ __forceinline__ void load_row(const int8_t* p, int n0, int N,
                                         uint32_t (&w)[C / 4]) {
  if (VEC) {                    // N % C == 0: the run is all in or all out
    if (n0 >= N) {
#pragma unroll
      for (int i = 0; i < C / 4; ++i) w[i] = 0u;
    } else if constexpr (C == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
    } else if constexpr (C == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x; w[1] = t.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + 4 * i + j < N)
          word |= (uint32_t)(uint8_t)__ldg(p + 4 * i + j) << (8 * j);
      w[i] = word;
    }
  }
}

// byte j of v (an int8 q biased to q + 128 by v = word ^ 0x80808080) as the
// float q: the byte goes into the mantissa of 2^23, and 2^23 + 128 comes
// off, both exact
__device__ __forceinline__ float int8_at(uint32_t v, int j) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + j)) - 8388736.f;
}

// One launch for every M.  A block owns TILE = 8 C columns (8 lanes x C
// consecutive columns, one C-byte load a row), MT rows of x and one slice
// of the contraction; its THREADS / 8 row-lanes each walk a contiguous run
// of the slice's rows, UNROLL rows in flight.  Their sums meet in shared
// memory in a fixed order.  One slice: the block scales and writes the
// output.  Several: it writes an f32 partial [S, M, N], and the last block
// to arrive on its column tile (an integer arrival counter, which that
// block resets to 0) adds the partials in slice order and scales them.
template <int MT, int C, int THREADS, int UNROLL, bool VEC>
__global__ void __launch_bounds__(THREADS, THREADS < 512 ? 512 / THREADS : 1)
    matmul_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ part,
                  float* __restrict__ out, int* __restrict__ arrivals, int M,
                  int D, int N, int slice_rows) {
  constexpr int NW = C / 4, TILE = COL_LANES * C, OUTS = MT * TILE;
  constexpr int ROW_LANES = THREADS / COL_LANES;  // warps x 4
  constexpr int RS = OUTS + 8;   // row stride of red: a warp hits 32 banks
  static_assert(OUTS <= THREADS, "one thread per output");
  // the row-lanes' sums of an output are added by P threads, K each, then
  // by one in part order
  constexpr int P = THREADS / OUTS < ROW_LANES ? THREADS / OUTS : ROW_LANES;
  constexpr int K = ROW_LANES / P;
  __shared__ float red[ROW_LANES * RS];
  __shared__ float red2[P * OUTS];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rl = (tid >> 5) * 4 + (lane >> 3), cl = lane & 7;  // row, col lane
  const int m0 = blockIdx.z * MT, rows = min(MT, M - m0);
  const int n0 = blockIdx.x * TILE + cl * C;
  const int r0 = blockIdx.y * slice_rows, r1 = min(r0 + slice_rows, D);
  const int run = (r1 - r0 + ROW_LANES - 1) / ROW_LANES;
  const int start = min(r0 + rl * run, r1), end = min(start + run, r1);

  float acc[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  for (int r = start; r < end; r += UNROLL) {
    uint32_t wv[UNROLL][NW];
    float xv[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u;
      if (rr < end) {
        load_row<C, VEC>(w + (long long)rr * N + n0, n0, N, wv[u]);
      } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) wv[u][i] = 0u;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
        xv[u][m] = rr < end && m < rows
                       ? __bfloat162float(x[(long long)(m0 + m) * D + rr])
                       : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u >= end) break;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const uint32_t v = wv[u][i] ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = int8_at(v, j);
#pragma unroll
          for (int m = 0; m < MT; ++m)
            acc[m][4 * i + j] = fmaf(xv[u][m], q, acc[m][4 * i + j]);
        }
      }
    }
  }

  // red[rl][(m * C + c) * 8 + cl]: the row-lanes' sums, added in a fixed
  // order, the last step by the thread that owns output (m, n)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) red[rl * RS + (m * C + c) * 8 + cl] = acc[m][c];
  __syncthreads();
  if (tid < P * OUTS) {
    const int o = tid % OUTS, p = tid / OUTS;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) s += red[(p * K + i) * RS + o];
    red2[tid] = s;
  }
  __syncthreads();
  const int m = tid / (8 * C), c = (tid / 8) % C;
  const int n = blockIdx.x * TILE + (tid % 8) * C + c;
  const bool ok = tid < OUTS && m < rows && n < N;
  float sum = 0.f;
  if (ok)
#pragma unroll
    for (int p = 0; p < P; ++p) sum += red2[p * OUTS + tid];
  if (gridDim.y == 1) {
    if (ok) out[(long long)(m0 + m) * N + n] = sum * scale[n];
    return;
  }
  // the last block to arrive on this column tile adds the slices' partials
  // in slice order, scales them and resets the tile's counter
  if (ok) part[((long long)blockIdx.y * M + m0 + m) * N + n] = sum;
  __threadfence();
  __syncthreads();
  const int slot = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(arrivals + slot, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ok) {
    float total = 0.f;
    for (int s = 0; s < (int)gridDim.y; ++s)
      total += __ldcg(part + ((long long)s * M + m0 + m) * N + n);
    out[(long long)(m0 + m) * N + n] = total * scale[n];
  }
  if (tid == 0) arrivals[slot] = 0;
}

template <int MT, int C, int THREADS, int UNROLL, bool VEC>
int launch_matmul(const void* x, const void* w, const void* scale, void* part,
                  void* out, void* arrivals, int M, int D, int N,
                  int slice_rows, cudaStream_t s) {
  constexpr int TILE = COL_LANES * C;
  dim3 grid((N + TILE - 1) / TILE, (D + slice_rows - 1) / slice_rows,
            (M + MT - 1) / MT);
  matmul_kernel<MT, C, THREADS, UNROLL, VEC><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale,
      (float*)part, (float*)out, (int*)arrivals, M, D, N, slice_rows);
  return (int)cudaGetLastError();
}

// the shapes the wrapper's planner picks (kernels/int8_matmul.py
// `split_plan`): at M = 1 C = 4, 8 or 16 bytes a lane in blocks of 512 or
// 1024 threads (one slice), 16 in blocks of 128-512 (split, or many column
// tiles); C = 16 / MT for MT = 2 and 4 rows of x (M > 4 in row tiles of 4),
// in blocks of 128.  A lane keeps 8 rows in flight, 16 with 4-byte lanes
// in blocks of 512, where a lane's 16 rows of a 1024-row slice then go out
// at once
template <bool VEC>
int dispatch_matmul(const void* x, const void* w, const void* scale,
                    void* part, void* out, void* arrivals, int M, int D, int N,
                    int slice_rows, int cols, int threads, cudaStream_t s) {
  const int mt = M == 1 ? 1 : M == 2 ? 2 : 4;
#define TSK_MATMUL(MT, C, T, U)                                              \
  if (mt == MT && cols == C && threads == T)                                 \
    return launch_matmul<MT, C, T, U, VEC>(x, w, scale, part, out, arrivals, \
                                           M, D, N, slice_rows, s);
  TSK_MATMUL(1, 4, 512, 16)
  TSK_MATMUL(1, 4, 1024, 8)
  TSK_MATMUL(1, 8, 512, 8)
  TSK_MATMUL(1, 8, 1024, 8)
  TSK_MATMUL(1, 16, 128, 8)
  TSK_MATMUL(1, 16, 256, 8)
  TSK_MATMUL(1, 16, 512, 8)
  TSK_MATMUL(2, 8, 128, 8)
  TSK_MATMUL(4, 4, 128, 8)
#undef TSK_MATMUL
  return (int)cudaErrorInvalidValue;
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

// x [M, D] bf16, w [D, N] int8, scale [N] f32, out [M, N] f32; all
// contiguous.  One launch: blocks of `threads` with `cols` bytes a lane
// (16 / MT for MT = 2, 4 rows of x a block, M > 4 in row tiles of 4; 16, 8
// or 4 at M = 1: the pairs of dispatch_matmul), slice_rows contraction
// rows a slice, part an f32
// workspace [ceil(D / slice_rows), M, N] (unused with one slice), arrivals
// int32 counters, zero, one per column tile and row tile; vec: N % cols ==
// 0 and w `cols`-byte aligned.
extern "C" int tsk_matmul_int8(const void* x, const void* w, const void* scale,
                               void* part, void* out, void* arrivals, int M,
                               int D, int N, int slice_rows, int cols,
                               int threads, int vec, void* stream) {
  if (M <= 0 || D <= 0 || N <= 0 || slice_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return vec ? dispatch_matmul<true>(x, w, scale, part, out, arrivals, M, D, N,
                                     slice_rows, cols, threads, s)
             : dispatch_matmul<false>(x, w, scale, part, out, arrivals, M, D,
                                      N, slice_rows, cols, threads, s);
}
