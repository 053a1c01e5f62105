// Fused int8 MLPs for Hopper, one call for the whole MLP:
//   gated (Llama):      y = (act(x Wg * sg) * (x Wu * su)) Wd * sd
//   plain (conformer):  y = act(x W1 * s1 + b1) W2 * s2 + b2
// x [M, H] bf16; Wg, Wu, W1 [H, I] int8 and Wd, W2 [I, H] int8 with f32
// per-output-channel scales; f32 biases; out [M, H] f32.
//
// Replaces ops/pallas/fused_mlp.py `gated_mlp_int8` (`_gated_kernel_i8`)
// and `ffn_int8` (`_ffn_kernel_i8`).  The TPU kernels run a sequential grid
// over tiles of I and carry the [M, H] f32 output in VMEM from one step to
// the next.  Blocks on the card run in parallel and in no order.
//
// The gated MLP is one launch of gated_mlp.cuh's kernels (the design is in
// that header): clusters over I whose ranks split the contraction and meet
// in distributed shared memory, the clusters' partials summed by the last
// block to arrive; one row of x on the SIMT units, more rows on the tensor
// cores, the int8 weights made floats by bit operations.  Bound on the
// H100: the bytes, 50.3 MB of weights at the Llama shapes (about 15 us at
// 3.35 TB/s) for 0.1 GFLOP a row of x.
//
// The FFN (ffn_int8) keeps two launches:
//   pass 1: block (s, row tile) owns the I range [s*TS, (s+1)*TS).  For each
//           32-column subtile it forms x W1 with its 8 warps splitting H,
//           reduces the warp sums in shared memory in a fixed order, applies
//           scale, bias and activation on the f32 sums and keeps a =
//           bf16(...) in shared memory (the activation never reaches device
//           memory).  Then it multiplies a by its TS rows of W2 and writes
//           the partial [M, H] sum to a scratch slot;
//   pass 2: sums the S slots in slot order, applies s2 and b2, so the
//           result is the same in every run (no float atomics).
// S is chosen from M so that about two blocks run per SM.  The conformer
// FFN moves 4.2 MB at decode (about 1.3 us).  Each weight byte is read
// once per row tile of MT rows (MT = 1 at decode, 8 otherwise) on the SIMT
// units; rows beyond 8 take further row tiles, which read the weights
// again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_mlp.cuh"

namespace {

constexpr int WARPS = 8, THREADS = WARPS * 32, SUB = 32;

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

struct Args {
  const __nv_bfloat16* x;   // [M, H]
  const int8_t* w1;         // [H, I]
  const float* s1;          // [I]
  const float* b1;          // [I]
  const int8_t* w2;         // [I, H]
  const float* s2;          // [H]
  const float* b2;          // [H]
  float* part;              // [S, M, H]
  float* out;               // [M, H]
  int M, H, I, TS, S, act;
};

template <int MT>
__global__ void __launch_bounds__(THREADS) mlp_pass1(Args g) {
  extern __shared__ float smem[];
  float* xs = smem;                              // [MT][H]
  float* red = xs + MT * g.H;                    // [2][WARPS][MT][SUB]
  float* as = red + 2 * WARPS * MT * SUB;        // [MT][TS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x, m0 = blockIdx.y * MT;
  const int rows = min(MT, g.M - m0);
  const int i0 = s * g.TS;
  for (int i = tid; i < MT * g.H; i += THREADS) {
    const int m = i / g.H;
    xs[i] = m < rows ? __bfloat162float(g.x[(long long)(m0 + m) * g.H + i % g.H])
                     : 0.f;
  }
  __syncthreads();

  // first projection: lane (cg, slice) holds 4 columns of one H slice
  const int cg = lane & 7, slice = warp * 4 + (lane >> 3);
  for (int j = 0; j < g.TS; j += SUB) {
    const int col = i0 + j + cg * 4;
    float a1[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) a1[m][k] = 0.f;
#pragma unroll 4
    for (int h = slice; h < g.H; h += 32) {
      const char4 w = __ldg(reinterpret_cast<const char4*>(
          g.w1 + (long long)h * g.I + col));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m * g.H + h];
        a1[m][0] = fmaf(xv, (float)w.x, a1[m][0]);
        a1[m][1] = fmaf(xv, (float)w.y, a1[m][1]);
        a1[m][2] = fmaf(xv, (float)w.z, a1[m][2]);
        a1[m][3] = fmaf(xv, (float)w.w, a1[m][3]);
      }
    }
    // lanes cg, cg + 8, cg + 16, cg + 24 share columns: fixed-order shuffles
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a1[m][k] += __shfl_xor_sync(0xffffffffu, a1[m][k], 8);
        a1[m][k] += __shfl_xor_sync(0xffffffffu, a1[m][k], 16);
      }
    if (lane < 8) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red[(warp * MT + m) * SUB + cg * 4 + k] = a1[m][k];
        }
    }
    __syncthreads();
    for (int e = tid; e < MT * SUB; e += THREADS) {
      const int m = e / SUB, c = e % SUB, ic = i0 + j + c;
      float v1 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v1 += red[(w * MT + m) * SUB + c];
      as[m * g.TS + j + c] = round_bf16(act_fn(v1 * g.s1[ic] + g.b1[ic], g.act));
    }
    __syncthreads();
  }

  // second projection over this block's TS rows: 8 output columns a thread
  for (int n = tid * 8; n < g.H; n += THREADS * 8) {
    float acc[MT][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[m][k] = 0.f;
#pragma unroll 4
    for (int c = 0; c < g.TS; ++c) {
      const int2 raw = __ldg(reinterpret_cast<const int2*>(
          g.w2 + (long long)(i0 + c) * g.H + n));
      const int8_t* w = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float av = as[m * g.TS + c];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[m][k] = fmaf(av, (float)w[k], acc[m][k]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= rows) break;
      float4* dst = reinterpret_cast<float4*>(
          g.part + ((long long)s * g.M + m0 + m) * g.H + n);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
}

__global__ void mlp_pass2(Args g) {
  const long long mh = (long long)g.M * g.H;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mh) return;
  const int n = (int)(i % g.H);
  float acc = 0.f;
  for (int s = 0; s < g.S; ++s) acc += g.part[s * mh + i];
  g.out[i] = g.b2[n] + acc * g.s2[n];
}

template <int MT>
int launch(const Args& a, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)MT * a.H + 2 * WARPS * MT * SUB + (size_t)MT * a.TS);
  auto kern = mlp_pass1<MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.S, (a.M + MT - 1) / MT);
  kern<<<grid, THREADS, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long mh = (long long)a.M * a.H;
  mlp_pass2<<<(unsigned)((mh + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int run(const Args& a, cudaStream_t st) {
  if (a.H % 8 || a.I % SUB || a.TS % SUB || a.S * a.TS != a.I)
    return (int)cudaErrorInvalidValue;
  return a.M == 1 ? launch<1>(a, st) : launch<8>(a, st);
}

}  // namespace

// x [M, H] bf16, wg / wu [H, I] int8, sg / su [I] f32, wd [I, H] int8, sd
// [H] f32, out [M, H] f32; part an f32 workspace [S, M, H] with S from
// tsk_gated_geometry_int8, and arrivals int32 counters, zero, one per rank
// and row tile of 16 (both unused where S = 1).  The plan: `cluster`
// blocks a cluster (1-8), `cols` columns of I a cluster (128 or 256);
// `slots` > 0 (M = 1, H % 16 == 0) takes the SIMT kernel with that many
// clusters instead (`cols` unused).
// Needs H % 8 == 0, I % 32 == 0 and 16-byte aligned tensors.
extern "C" int tsk_gated_mlp_int8(const void* x, const void* wg, const void* sg,
                                  const void* wu, const void* su, const void* wd,
                                  const void* sd, void* part, void* out,
                                  void* arrivals, int M, int H, int I, int act,
                                  int cluster, int cols, int slots,
                                  void* stream) {
  if (H % 8 || I % 32) return (int)cudaErrorInvalidValue;
  gated::Args a{};
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)wg; a.sg = (const float*)sg;
  a.wu = (const uint8_t*)wu; a.su = (const float*)su;
  a.wd = (const uint8_t*)wd; a.sd = (const float*)sd;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.M = M; a.H = H; a.I = I; a.act = act;
  a.C = cluster; a.TS = cols; a.slots = slots;
  return gated::run<false>(a, (cudaStream_t)stream);
}

// The geometry of a plan (arguments as above) as the kernel takes it:
// out[0] = S, the slots of `part`; out[1] = the first row of Wd that the
// last slot owns.  An error where the kernel cannot take the plan.
extern "C" int tsk_gated_geometry_int8(int M, int H, int I, int cluster,
                                       int cols, int slots, int* out) {
  if (H % 8 || I % 32) return (int)cudaErrorInvalidValue;
  gated::Args a{};
  a.M = M; a.H = H; a.I = I;
  a.C = cluster; a.TS = cols; a.slots = slots;
  return gated::geometry<false>(a, out);
}

// Shapes as in the header; part is [S, M, H] f32 scratch with S * TS == I.
// Needs H % 8 == 0, I % 32 == 0, TS % 32 == 0 and 16-byte aligned tensors.
extern "C" int tsk_ffn_int8(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* part, void* out, int M, int H,
                            int I, int TS, int act, void* stream) {
  Args a{};
  a.x = (const __nv_bfloat16*)x;
  a.w1 = (const int8_t*)w1; a.s1 = (const float*)s1; a.b1 = (const float*)b1;
  a.w2 = (const int8_t*)w2; a.s2 = (const float*)s2; a.b2 = (const float*)b2;
  a.part = (float*)part; a.out = (float*)out;
  a.M = M; a.H = H; a.I = I; a.TS = TS; a.S = TS > 0 ? I / TS : 0; a.act = act;
  return run(a, (cudaStream_t)stream);
}
