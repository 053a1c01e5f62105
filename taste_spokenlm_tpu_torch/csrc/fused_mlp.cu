// Fused int8 MLPs for Hopper, one launch for the whole MLP:
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
// Both are one launch of gated_mlp.cuh's kernels (the design is in that
// header), the FFN as their compile-time FFN variant: clusters over I whose
// ranks split the contraction and meet in distributed shared memory, the
// clusters' partials summed by the last block to arrive; one row of x on
// the SIMT units, more rows on the tensor cores, the int8 weights made
// floats by bit operations.  Bound on the H100: the bytes, 50.3 MB of
// weights at the Llama shapes (about 15 us at 3.35 TB/s) for 0.1 GFLOP a
// row of x; the conformer FFN's 4.2 MB (about 1.3 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_mlp.cuh"

namespace {

// the plan's arguments (see tsk_gated_mlp_int8) into the kernels' Args
gated::Args plan_args(int M, int H, int I, int cluster, int cols, int slots) {
  gated::Args a{};
  a.M = M; a.H = H; a.I = I;
  a.C = cluster; a.TS = cols; a.slots = slots;
  return a;
}

}  // namespace

// x [M, H] bf16, wg / wu [H, I] int8, sg / su [I] f32, wd [I, H] int8, sd
// [H] f32, out [M, H] f32; part an f32 workspace [S, M, H] with S from
// tsk_gated_geometry_int8, and arrivals int32 counters, zero, one per rank
// and block of rows (both unused where S = 1).  The plan: `cluster`
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
  gated::Args a = plan_args(M, H, I, cluster, cols, slots);
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)wg; a.sg = (const float*)sg;
  a.wu = (const uint8_t*)wu; a.su = (const float*)su;
  a.wd = (const uint8_t*)wd; a.sd = (const float*)sd;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.act = act;
  return gated::run<false, false>(a, (cudaStream_t)stream);
}

// The geometry of a plan (arguments as above) as the kernel takes it:
// out[0] = S, the slots of `part`; out[1] = the first row of Wd that the
// last slot owns; out[2] = the blocks of rows of x (arrival counters: out[2]
// x cluster).  An error where the kernel cannot take the plan.
extern "C" int tsk_gated_geometry_int8(int M, int H, int I, int cluster,
                                       int cols, int slots, int* out) {
  if (H % 8 || I % 32) return (int)cudaErrorInvalidValue;
  return gated::geometry<false, false>(
      plan_args(M, H, I, cluster, cols, slots), out);
}

// The conformer FFN: x [M, H] bf16, w1 [H, I] int8, s1 / b1 [I] f32, w2
// [I, H] int8, s2 / b2 [H] f32, out [M, H] f32; part, arrivals and the plan
// as for tsk_gated_mlp_int8, S from tsk_ffn_geometry_int8.
// Needs H % 8 == 0, I % 32 == 0 and 16-byte aligned tensors.
extern "C" int tsk_ffn_int8(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* part, void* out,
                            void* arrivals, int M, int H, int I, int act,
                            int cluster, int cols, int slots, void* stream) {
  if (H % 8 || I % 32) return (int)cudaErrorInvalidValue;
  gated::Args a = plan_args(M, H, I, cluster, cols, slots);
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)w1; a.sg = (const float*)s1; a.b1 = (const float*)b1;
  a.wd = (const uint8_t*)w2; a.sd = (const float*)s2; a.b2 = (const float*)b2;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.act = act;
  return gated::run<false, true>(a, (cudaStream_t)stream);
}

// The FFN's geometry of a plan, as tsk_gated_geometry_int8's (out[1]: the
// first row of W2 that the last slot owns).
extern "C" int tsk_ffn_geometry_int8(int M, int H, int I, int cluster,
                                     int cols, int slots, int* out) {
  if (H % 8 || I % 32) return (int)cudaErrorInvalidValue;
  return gated::geometry<false, true>(
      plan_args(M, H, I, cluster, cols, slots), out);
}
