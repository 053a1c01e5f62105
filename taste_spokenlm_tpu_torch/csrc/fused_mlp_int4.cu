// Fused int4 MLPs for Hopper, one call for the whole MLP:
//   gated (Llama):      y = (act(x Wg) * (x Wu)) Wd
//   plain (conformer):  y = act(x W1 + b1) W2 + b2
// x [M, H] bf16.  Wg, Wu, W1 are nibble-packed [H/2, I] uint8 (low nibble:
// contraction row r, high nibble: row H/2 + r, two's complement) with
// group-wise f32 scales [H/gin, I], low-plane groups first.  Wd, W2 are
// packed PER TILE of BI rows of I, [I/2, H]: in packed row t*BI/2 + r the
// low nibble is I-row t*BI + r and the high nibble I-row t*BI + BI/2 + r;
// tile t's scales are rows [t*SPT, (t+1)*SPT) of [I/gmid, H], low-plane
// groups first.  f32 biases; out [M, H] f32.
//
// Replaces ops/pallas/fused_mlp.py `gated_mlp_int4` (`_gated_kernel_i4`)
// and `ffn_int4` (`_ffn_kernel_i4`), whose sequential grid walks the I
// tiles and carries the [M, H] f32 output in VMEM.  Blocks on the card run
// in parallel and in no order.
//
// The gated MLP is one launch of gated_mlp.cuh's kernels (the design is in
// that header): a cluster owns a range of Wd's packed rows and the two
// column runs of Wg / Wu they pair, its ranks split the contraction and
// meet in distributed shared memory, the clusters' partials are summed by
// the last block to arrive; one row of x on the SIMT units, more rows on
// the tensor cores, the nibbles made floats by bit operations, each
// (plane, group) partial scaled on its own.  Bound on the H100: the bytes,
// 25.2 MB of nibbles and 1.6 MB of f32 scales at the Llama shapes (about
// 8 us at 3.35 TB/s).
//
// The FFN (ffn_int4) keeps two launches:
//   pass 1: block (u, row tile) owns R packed rows [r0, r0 + R) of one tile
//           t of the second projection.  Those rows pair I-columns
//           t*BI + r0 + [0, R) (low nibbles) with t*BI + BI/2 + r0 + [0, R)
//           (high nibbles), so the block forms the first projection on
//           those two column ranges, 16 + 16 at a time: its 32 contraction
//           slices each take chunks of CH packed rows that lie inside one
//           scale group, sum the low- and high-plane products of a chunk in
//           f32 and scale each on its own (a split inside a group moves
//           only the rounding); the slices meet by fixed-order shuffles and
//           shared memory.  The activation a = bf16(...) stays in shared
//           memory.  Then the block multiplies a by its R packed rows of
//           W2, group segment by group segment, each (plane, group) partial
//           scaled on its own, into a scratch slot [u, M, H];
//   pass 2: sums the slots in slot order (+ b2), so the result is the same
//           in every run (no float atomics).
// R is chosen from M so that about two blocks run per SM.  Group sizes are
// runtime values (tiny widths have groups of 16 or 32).  The conformer FFN
// moves about 2.2 MB at decode (0.7 us), so it is launch-bound.  Each
// weight byte is read once per row tile of MT rows (MT = 1 at decode, 8
// otherwise) on the SIMT units; more rows take further row tiles, which
// read the weights again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_mlp.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int SUBR = 16;        // packed second-projection rows per subtile
constexpr int SUB = 2 * SUBR;   // first-projection columns per subtile
constexpr int SLICES = 32;      // contraction slices of the first projection

enum Act { ACT_SILU = 0, ACT_RELU = 1, ACT_GELU_TANH = 2 };

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU_TANH) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// byte c of a little-endian word: its low / high nibble, sign-extended
// exactly by int32 shifts
__device__ __forceinline__ float nib_lo(uint32_t w, int c) {
  return (float)((int32_t)(w << (28 - 8 * c)) >> 28);
}

__device__ __forceinline__ float nib_hi(uint32_t w, int c) {
  return (float)((int32_t)(w << (24 - 8 * c)) >> 28);
}

__device__ __forceinline__ uint32_t ld_word(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ float4 ld_f4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

struct Args {
  const __nv_bfloat16* x;   // [M, H]
  const uint8_t* w1;        // [H/2, I]
  const float* s1;          // [H/GIN, I]
  const float* b1;          // [I]
  const uint8_t* w2;        // [I/2, H] per tile
  const float* s2;          // [I/BI * SPT, H]
  const float* b2;          // [H]
  float* part;              // [S, M, H]
  float* out;               // [M, H]
  int M, H, I, BI, GIN, CH, SPT, GMID, R, S, act;
};

// x [MT] rows . packed [H/2, I] columns col..col+3 over chunks `slice`,
// `slice` + SLICES, ... of CH packed rows; each chunk's plane sums scaled
// on their own.  -> acc[m][c]
template <int MT>
__device__ __forceinline__ void first_proj(const Args& g, const float* xs,
                                           const uint8_t* w, const float* sc,
                                           int col, int slice,
                                           float (&acc)[MT][4]) {
  const int half = g.H / 2, n_g = half / g.GIN, n_items = half / g.CH;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  for (int it = slice; it < n_items; it += SLICES) {
    const int h0 = it * g.CH, grp = h0 / g.GIN;
    float lo[MT][4], hi[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) lo[m][c] = hi[m][c] = 0.f;
#pragma unroll 4
    for (int h = h0; h < h0 + g.CH; ++h) {
      const uint32_t wv = ld_word(w + (long long)h * g.I + col);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs[m * g.H + h], xh = xs[m * g.H + half + h];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[m][c] = fmaf(xl, nib_lo(wv, c), lo[m][c]);
          hi[m][c] = fmaf(xh, nib_hi(wv, c), hi[m][c]);
        }
      }
    }
    const float4 sl = ld_f4(sc + (long long)grp * g.I + col);
    const float4 sh = ld_f4(sc + (long long)(n_g + grp) * g.I + col);
    const float s_lo[4] = {sl.x, sl.y, sl.z, sl.w};
    const float s_hi[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[m][c] += lo[m][c] * s_lo[c] + hi[m][c] * s_hi[c];
  }
}

template <int MT>
__global__ void __launch_bounds__(THREADS) mlp4_pass1(Args g) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [MT][H]
  float* red = xs + MT * g.H;                    // [2][WARPS][MT][SUB]
  float* as = red + 2 * WARPS * MT * SUB;        // [MT][2R]: low, then high
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int units = (g.BI / 2) / g.R;
  const int t = blockIdx.x / units, r0 = (blockIdx.x % units) * g.R;
  const int m0 = blockIdx.y * MT;
  const int rows = min(MT, g.M - m0);
  for (int i = tid; i < MT * g.H; i += THREADS) {
    const int m = i / g.H;
    xs[i] = m < rows ? __bfloat162float(g.x[(long long)(m0 + m) * g.H + i % g.H])
                     : 0.f;
  }
  __syncthreads();

  // first projection: lane (cg, slice) holds 4 columns; cg < 4 are in the
  // low range, cg >= 4 in the high range of this subtile
  const int cg = lane & 7, slice = warp * 4 + (lane >> 3);
  for (int j = 0; j < g.R; j += SUBR) {
    const int col = t * g.BI + (cg < 4 ? 0 : g.BI / 2) + r0 + j + (cg & 3) * 4;
    {
      float acc[MT][4];
      first_proj<MT>(g, xs, g.w1, g.s1, col, slice, acc);
      // lanes cg, cg + 8, cg + 16, cg + 24 share columns: fixed-order shuffles
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 8);
          acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
        }
      if (lane < 8) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(warp * MT + m) * SUB + cg * 4 + c] = acc[m][c];
      }
    }
    __syncthreads();
    for (int e = tid; e < MT * SUB; e += THREADS) {
      const int m = e / SUB, c = e % SUB;
      const bool high = c >= SUBR;
      const int r = j + c % SUBR;
      float v1 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v1 += red[(w * MT + m) * SUB + c];
      const float a =
          act_fn(v1 + g.b1[t * g.BI + (high ? g.BI / 2 : 0) + r0 + r], g.act);
      as[m * 2 * g.R + (high ? g.R : 0) + r] = round_bf16(a);
    }
    __syncthreads();
  }

  // second projection over this block's R packed rows: 4 output columns a
  // thread, one scale-group segment at a time
  const float* s_lo = g.s2 + (long long)t * g.SPT * g.H;
  const float* s_hi = s_lo + (long long)(g.SPT / 2) * g.H;
  const uint8_t* w2 = g.w2 + ((long long)t * (g.BI / 2) + r0) * g.H;
  for (int n = tid * 4; n < g.H; n += THREADS * 4) {
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
    for (int r = 0; r < g.R;) {
      const int grp = (r0 + r) / g.GMID;
      const int r_end = min(g.R, (grp + 1) * g.GMID - r0);
      float lo[MT][4], hi[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) lo[m][c] = hi[m][c] = 0.f;
#pragma unroll 4
      for (; r < r_end; ++r) {
        const uint32_t wv = ld_word(w2 + (long long)r * g.H + n);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float al = as[m * 2 * g.R + r], ah = as[m * 2 * g.R + g.R + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[m][c] = fmaf(al, nib_lo(wv, c), lo[m][c]);
            hi[m][c] = fmaf(ah, nib_hi(wv, c), hi[m][c]);
          }
        }
      }
      const float4 sl = ld_f4(s_lo + (long long)grp * g.H + n);
      const float4 sh = ld_f4(s_hi + (long long)grp * g.H + n);
      const float sl4[4] = {sl.x, sl.y, sl.z, sl.w};
      const float sh4[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[m][c] += lo[m][c] * sl4[c] + hi[m][c] * sh4[c];
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= rows) break;
      *reinterpret_cast<float4*>(
          g.part + ((long long)blockIdx.x * g.M + m0 + m) * g.H + n) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

__global__ void mlp4_pass2(Args g) {
  const long long mh = (long long)g.M * g.H;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mh) return;
  float acc = 0.f;
  for (int s = 0; s < g.S; ++s) acc += g.part[s * mh + i];
  g.out[i] = g.b2[i % g.H] + acc;
}

template <int MT>
int launch(const Args& a, cudaStream_t st) {
  const size_t smem = sizeof(float) * ((size_t)MT * a.H + 2 * WARPS * MT * SUB +
                                       (size_t)MT * 2 * a.R);
  auto kern = mlp4_pass1<MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S, (a.M + MT - 1) / MT);
  kern<<<grid, THREADS, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long mh = (long long)a.M * a.H;
  mlp4_pass2<<<(unsigned)((mh + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// largest divisor of n not above cap
int chunk_of(int n, int cap) {
  int c = n < cap ? n : cap;
  while (c > 1 && n % c) --c;
  return c;
}

int run(Args& a, cudaStream_t st) {
  if (a.H % 4 || a.I % 4 || a.BI <= 0 || a.BI % SUB || a.I % a.BI ||
      a.R <= 0 || a.R % SUBR || (a.BI / 2) % a.R || a.GIN <= 0 ||
      (a.H / 2) % a.GIN || a.SPT <= 0 || a.SPT % 2 || (a.BI / 2) % (a.SPT / 2))
    return (int)cudaErrorInvalidValue;
  a.CH = chunk_of(a.GIN, 32);
  a.GMID = (a.BI / 2) / (a.SPT / 2);
  a.S = (a.I / 2) / a.R;
  return a.M == 1 ? launch<1>(a, st) : launch<8>(a, st);
}

Args make_args(const void* x, const void* w1, const void* s1, const void* w2,
               const void* s2, void* part, void* out, int M, int H, int I,
               int tile, int group_in, int spt, int R, int act) {
  Args a{};
  a.x = (const __nv_bfloat16*)x;
  a.w1 = (const uint8_t*)w1; a.s1 = (const float*)s1;
  a.w2 = (const uint8_t*)w2; a.s2 = (const float*)s2;
  a.part = (float*)part; a.out = (float*)out;
  a.M = M; a.H = H; a.I = I; a.BI = tile; a.GIN = group_in; a.SPT = spt;
  a.R = R; a.act = act;
  return a;
}

}  // namespace

// x [M, H] bf16, wg / wu packed [H/2, I] uint8 with scales [H/2/group_in
// * 2, I] f32, wd packed per tile of `tile` rows [I/2, H] with `spt` scale
// rows a tile, out [M, H] f32; part an f32 workspace [S, M, H] with S from
// tsk_gated_geometry_int4, and arrivals int32 counters, zero, one per rank
// and row tile of 16 (both unused where S = 1).  The plan: `cluster`
// blocks a cluster (1-8), `cols` columns of I a cluster (128 or 256:
// cols/2 packed rows of Wd); `slots` > 0 (M = 1, H % 16 == 0) takes the
// SIMT kernel with that many clusters instead (`cols` unused).  Needs
// H % 4 == 0, tile % 32 == 0 and 16-byte aligned tensors.
extern "C" int tsk_gated_mlp_int4(const void* x, const void* wg, const void* sg,
                                  const void* wu, const void* su, const void* wd,
                                  const void* sd, void* part, void* out,
                                  void* arrivals, int M, int H, int I, int tile,
                                  int group_in, int spt, int act, int cluster,
                                  int cols, int slots, void* stream) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  gated::Args a{};
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)wg; a.sg = (const float*)sg;
  a.wu = (const uint8_t*)wu; a.su = (const float*)su;
  a.wd = (const uint8_t*)wd; a.sd = (const float*)sd;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.M = M; a.H = H; a.I = I; a.act = act;
  a.BI = tile; a.GIN = group_in; a.SPT = spt;
  a.C = cluster; a.TS = cols; a.slots = slots;
  return gated::run<true, false>(a, (cudaStream_t)stream);
}

// The geometry of a plan (arguments as above) as the kernel takes it:
// out[0] = S, the slots of `part`; out[1] = the first packed row of Wd
// that the last slot owns; out[2] = the blocks of rows of x.  An error where
// the kernel cannot take the plan.
extern "C" int tsk_gated_geometry_int4(int M, int H, int I, int tile,
                                       int group_in, int spt, int cluster,
                                       int cols, int slots, int* out) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  gated::Args a{};
  a.M = M; a.H = H; a.I = I;
  a.BI = tile; a.GIN = group_in; a.SPT = spt;
  a.C = cluster; a.TS = cols; a.slots = slots;
  return gated::geometry<true, false>(a, out);
}

// Shapes as in the header; part is [I/2/R, M, H] f32 scratch.  group_in is
// the first projection's packed rows per scale row, spt the scale rows per
// tile of the second.  Needs H % 4 == 0, tile % 32 == 0, R % 16 == 0
// dividing tile/2, and 16-byte aligned tensors.
extern "C" int tsk_ffn_int4(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* part, void* out, int M, int H,
                            int I, int tile, int group_in, int spt, int R,
                            int act, void* stream) {
  Args a = make_args(x, w1, s1, w2, s2, part, out, M, H, I, tile, group_in,
                     spt, R, act);
  a.b1 = (const float*)b1; a.b2 = (const float*)b2;
  return run(a, (cudaStream_t)stream);
}
