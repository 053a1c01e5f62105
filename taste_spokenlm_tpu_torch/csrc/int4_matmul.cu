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
// 42 us at 3.35 TB/s against well under 1 us of arithmetic; a projection
// moves 0.5-8 MB, 0.2-2.7 us, so there the latency of the memory system
// and of the launch decides.  Every product of a bf16 x value and an int4
// weight is exact in f32, summed in f32 per scale group and scaled on the
// f32 sum, as on the TPU.
//
// M <= 8, int4_kernel_split (one launch):
//   * a block owns TILE = 8 C columns (8 lanes x C consecutive columns, one
//     C-byte load of a packed row) and one slice of the packed rows, cut on
//     scale-group edges, so one slice serves both nibble planes;
//   * its THREADS / 8 row-lanes each walk a contiguous run of the slice's
//     rows, UNROLL rows in flight at a time: every warp has work however
//     few groups D holds, and no lane waits on a chain of dependent loads.
//     A nibble becomes a float by a byte permute into the mantissa of 2^23
//     and one subtraction, not by an int-to-float conversion, which runs at
//     a fraction of the FMA rate (the head has 262 M nibbles);
//   * the row-lanes' sums meet in shared memory and are added in a fixed
//     order.  With one slice the block writes the output; otherwise it
//     writes an f32 partial [S, M, N] to a workspace, and the last block to
//     arrive on its column tile (an integer arrival counter, which that
//     block resets to 0) adds the partials in slice order.  No float
//     atomics: two calls give the same bits.  The counters persist between
//     calls, so launches that share them must not overlap (calls on one
//     stream, graph replays ordered with them);
//   * the wrapper picks the shape (kernels/int4_matmul.py `split_plan`).
//     The decode projections (N = 1024-16,384) give only 8-128 tiles of 128
//     columns, and the latency of a launch, a round trip to memory and a
//     cross-block sum decides their time, not the bytes (0.2-2.7 us of
//     them).  So at M = 1 a block has 512 threads, a lane at most 16 rows,
//     and the lanes narrow to 8 or 4 bytes until the tiles fill the card
//     once: at D <= 2048 one block takes the whole contraction and no
//     partial is written; D = 8192 takes 4 slices.  The head's 1,002 tiles
//     of 16-byte lanes fill it many times over, in blocks of 128 threads;
//     M = 2..8 takes C = 16 / MT for MT = 2 or 4 rows of x, 128 threads;
//   * the ragged column edge is masked, not padded.
// M > 8, int4_kernel (prefill): a block owns 128 columns and MT = 8 rows of
// x in shared memory and the whole contraction; its 8 warps split the scale
// groups.  Each further row tile reads the weights again: fine for the 42-
// and 131-row prefills, slow for large M, where a tensor-core version
// (wgmma on dequantized tiles) is the later step.
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
  float* red = smem;              // [WARPS][MT][TILE_N]
  __nv_bfloat16* xs =             // [MT][D]
      reinterpret_cast<__nv_bfloat16*>(smem + WARPS * MT * TILE_N);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, M - m0);
  const int n0 = blockIdx.x * TILE_N + lane * COLS;
  for (int i = tid; i < MT * D; i += THREADS) {
    const int m = i / D;
    xs[i] = m < rows ? x[(long long)(m0 + m) * D + i % D]
                     : __float2bfloat16(0.f);
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
        const float xl = __bfloat162float(xs[m * D + r]);
        const float xh = __bfloat162float(xs[m * D + half + r]);
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
int launch_rows(const void* x, const void* wp, const void* scale, void* out,
                int M, int D, int N, int group, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)MT * WARPS * TILE_N +
                      sizeof(__nv_bfloat16) * (size_t)MT * D;
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

// ---------------------------------------------------------------------------
// M <= 8: the contraction split over blocks
// ---------------------------------------------------------------------------

constexpr int COL_LANES = 8;    // lanes across a column tile
constexpr int UNROLL = 8;       // packed rows a lane has in flight

// C bytes of one packed row from p (columns n0.. of N) as C / 4
// little-endian words; bytes past N read as 0 (a zero nibble adds nothing).
template <int C, bool VEC>
__device__ __forceinline__ void load_row(const uint8_t* p, int n0, int N,
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
        if (n0 + 4 * i + j < N) word |= (uint32_t)__ldg(p + 4 * i + j) << (8 * j);
      w[i] = word;
    }
  }
}

// byte j of v (a biased nibble q + 8 in 0..15) as the float q: the byte goes
// into the mantissa of 2^23, and 2^23 + 8 comes off, both exact
__device__ __forceinline__ float nibble_at(uint32_t v, int j) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + j)) - 8388616.f;
}

template <int MT, int C, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS, 512 / THREADS) int4_kernel_split(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wp,
    const float* __restrict__ scale, float* __restrict__ part,
    float* __restrict__ out, int* __restrict__ arrivals, int M, int D,
    int N, int group, int slice_rows) {
  constexpr int NW = C / 4, TILE = COL_LANES * C, OUTS = MT * TILE;
  constexpr int ROW_LANES = THREADS / COL_LANES;  // warps x 4
  constexpr int RS = OUTS + 8;   // row stride of red: a warp hits 32 banks
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
  const int half = D / 2, n_g = half / group;
  const int r0 = blockIdx.y * slice_rows, r1 = min(r0 + slice_rows, half);
  const int run = (r1 - r0 + ROW_LANES - 1) / ROW_LANES;
  const int start = min(r0 + rl * run, r1), end = min(start + run, r1);

  float acc[MT][C], lo[MT][C], hi[MT][C];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = lo[m][c] = hi[m][c] = 0.f;
  // acc += the group's sums times its scales (both planes)
  auto flush = [&](int g) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool in = n0 + c < N;
      const float s_lo = in ? __ldg(scale + (long long)g * N + n0 + c) : 0.f;
      const float s_hi =
          in ? __ldg(scale + (long long)(n_g + g) * N + n0 + c) : 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][c] += lo[m][c] * s_lo + hi[m][c] * s_hi;
        lo[m][c] = hi[m][c] = 0.f;
      }
    }
  };
  int g = start / group, g_end = (g + 1) * group;

  for (int r = start; r < end; r += UNROLL) {
    uint32_t w[UNROLL][NW];
    float xl[UNROLL][MT], xh[UNROLL][MT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u;
      if (rr < end) {
        load_row<C, VEC>(wp + (long long)rr * N + n0, n0, N, w[u]);
      } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) w[u][i] = 0u;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const bool in = rr < end && m < rows;
        const __nv_bfloat16* xm = x + (long long)(m0 + m) * D;
        xl[u][m] = in ? __bfloat162float(xm[rr]) : 0.f;
        xh[u][m] = in ? __bfloat162float(xm[half + rr]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u;
      if (rr >= end) break;
      if (rr == g_end) {           // the run crosses into the next group
        flush(g++);
        g_end += group;
      }
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        const uint32_t vl = (w[u][i] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t vh = ((w[u][i] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float ql = nibble_at(vl, j), qh = nibble_at(vh, j);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            lo[m][4 * i + j] = fmaf(xl[u][m], ql, lo[m][4 * i + j]);
            hi[m][4 * i + j] = fmaf(xh[u][m], qh, hi[m][4 * i + j]);
          }
        }
      }
    }
  }
  if (start < end) flush(g);

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
    if (ok) out[(long long)(m0 + m) * N + n] = sum;
    return;
  }
  // the last block to arrive on this column tile adds the slices' partials
  // in slice order and resets the tile's counter
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
    out[(long long)(m0 + m) * N + n] = total;
  }
  if (tid == 0) arrivals[slot] = 0;
}

template <int MT, int C, int THREADS, bool VEC>
int launch_split(const void* x, const void* wp, const void* scale, void* part,
                 void* out, void* arrivals, int M, int D, int N, int group,
                 int slice_rows, cudaStream_t s) {
  constexpr int TILE = COL_LANES * C;
  dim3 grid((N + TILE - 1) / TILE, (D / 2 + slice_rows - 1) / slice_rows,
            (M + MT - 1) / MT);
  int4_kernel_split<MT, C, THREADS, VEC><<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)wp, (const float*)scale,
      (float*)part, (float*)out, (int*)arrivals, M, D, N, group, slice_rows);
  return (int)cudaGetLastError();
}

// the shapes the wrapper's planner picks: at M = 1 C = 4, 8 or 16 bytes a
// lane in blocks of 512 threads, or 16 in blocks of 128 (many column
// tiles); C = 16 / MT for MT = 2 and 4 rows of x, in blocks of 128
template <bool VEC>
int dispatch_split(const void* x, const void* wp, const void* scale,
                   void* part, void* out, void* arrivals, int M, int D, int N,
                   int group, int slice_rows, int cols, int threads,
                   cudaStream_t s) {
  const int mt = M == 1 ? 1 : M == 2 ? 2 : 4;
#define TSK_SPLIT(MT, C, T)                                                   \
  if (mt == MT && cols == C && threads == T)                                  \
    return launch_split<MT, C, T, VEC>(x, wp, scale, part, out, arrivals, M, \
                                       D, N, group, slice_rows, s);
  TSK_SPLIT(1, 16, 128)
  TSK_SPLIT(1, 16, 512)
  TSK_SPLIT(1, 8, 512)
  TSK_SPLIT(1, 4, 512)
  TSK_SPLIT(2, 8, 128)
  TSK_SPLIT(4, 4, 128)
#undef TSK_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [M, D] bf16, wp [D/2, N] uint8, scale [D/group, N] f32 (group = packed
// rows per scale row), out [M, N] f32; all contiguous.  Needs D even and
// (D/2) % group == 0.  M <= 8 takes the split kernel in blocks of `threads`
// (128, or 512 at M = 1) with `cols` bytes a lane (16 / MT for MT = 2, 4
// rows of x a block; 16, 8 or 4 at M = 1), slice_rows (a multiple of
// group) packed rows a slice, part an f32 workspace [ceil(D/2 /
// slice_rows), M, N] (unused with one slice), arrivals int32 counters,
// zero, one per column tile and row tile; vec: N % cols == 0 and wp
// `cols`-byte aligned.  M > 8 takes the row-tile kernel (vec: N % 4 == 0
// and wp 4-byte aligned; the split arguments unused).
extern "C" int tsk_matmul_int4(const void* x, const void* wp, const void* scale,
                               void* part, void* out, void* arrivals, int M,
                               int D, int N, int group, int slice_rows,
                               int cols, int threads, int vec, void* stream) {
  if (D % 2 || group <= 0 || (D / 2) % group) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 8) {
    if (slice_rows <= 0 || slice_rows % group) return (int)cudaErrorInvalidValue;
    return vec ? dispatch_split<true>(x, wp, scale, part, out, arrivals, M, D,
                                      N, group, slice_rows, cols, threads, s)
               : dispatch_split<false>(x, wp, scale, part, out, arrivals, M, D,
                                       N, group, slice_rows, cols, threads, s);
  }
  return vec ? launch_rows<8, true>(x, wp, scale, out, M, D, N, group, s)
             : launch_rows<8, false>(x, wp, scale, out, M, D, N, group, s);
}
