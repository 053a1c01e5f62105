// Fused int4 MLPs for Hopper, one launch for the whole MLP:
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
// Both are one launch of gated_mlp.cuh's kernels (the design is in that
// header), the FFN as their compile-time FFN variant: a cluster owns a
// range of Wd's (W2's) packed rows and the two column runs of the first
// projection they pair, its ranks split the contraction and meet in
// distributed shared memory (the FFN adds b1 there, before the
// activation), the clusters' partials are summed by the last block to
// arrive (the FFN adds b2 once, after that sum); one row of x on the SIMT
// units, more rows on the tensor cores, the nibbles made floats by bit
// operations, each (plane, group) partial scaled on its own.  Bound on the
// H100: the bytes, 25.2 MB of nibbles and 1.6 MB of f32 scales at the
// Llama shapes (about 8 us at 3.35 TB/s); the conformer FFN's 2.2 MB
// (about 0.7 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_mlp.cuh"

namespace {

// the shapes, the int4 layout and the plan (see tsk_gated_mlp_int4) into
// the kernels' Args
gated::Args plan_args(int M, int H, int I, int tile, int group_in, int spt,
                      int cluster, int cols, int slots) {
  gated::Args a{};
  a.M = M; a.H = H; a.I = I;
  a.BI = tile; a.GIN = group_in; a.SPT = spt;
  a.C = cluster; a.TS = cols; a.slots = slots;
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
  gated::Args a =
      plan_args(M, H, I, tile, group_in, spt, cluster, cols, slots);
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)wg; a.sg = (const float*)sg;
  a.wu = (const uint8_t*)wu; a.su = (const float*)su;
  a.wd = (const uint8_t*)wd; a.sd = (const float*)sd;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.act = act;
  return gated::run<true, false>(a, (cudaStream_t)stream);
}

// The geometry of a plan (arguments as above) as the kernel takes it:
// out[0] = S, the slots of `part`; out[1] = the first packed row of Wd that
// the last slot owns; out[2] = the blocks of rows of x.  An error where the
// kernel cannot take the plan.
extern "C" int tsk_gated_geometry_int4(int M, int H, int I, int tile,
                                       int group_in, int spt, int cluster,
                                       int cols, int slots, int* out) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  return gated::geometry<true, false>(
      plan_args(M, H, I, tile, group_in, spt, cluster, cols, slots), out);
}

// The conformer FFN: x [M, H] bf16, w1 packed [H/2, I] with scales as wg's,
// b1 [I] f32, w2 packed per tile as wd with scales as sd's, b2 [H] f32,
// out [M, H] f32; part, arrivals and the plan as for tsk_gated_mlp_int4,
// S from tsk_ffn_geometry_int4.  Needs H % 4 == 0, tile % 32 == 0 and
// 16-byte aligned tensors.
extern "C" int tsk_ffn_int4(const void* x, const void* w1, const void* s1,
                            const void* b1, const void* w2, const void* s2,
                            const void* b2, void* part, void* out,
                            void* arrivals, int M, int H, int I, int tile,
                            int group_in, int spt, int act, int cluster,
                            int cols, int slots, void* stream) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  gated::Args a =
      plan_args(M, H, I, tile, group_in, spt, cluster, cols, slots);
  a.x = (const __nv_bfloat16*)x;
  a.wg = (const uint8_t*)w1; a.sg = (const float*)s1; a.b1 = (const float*)b1;
  a.wd = (const uint8_t*)w2; a.sd = (const float*)s2; a.b2 = (const float*)b2;
  a.part = (float*)part; a.out = (float*)out; a.arrivals = (int*)arrivals;
  a.act = act;
  return gated::run<true, true>(a, (cudaStream_t)stream);
}

// The FFN's geometry of a plan, as tsk_gated_geometry_int4's (out[1]: the
// first packed row of W2 that the last slot owns).
extern "C" int tsk_ffn_geometry_int4(int M, int H, int I, int tile,
                                     int group_in, int spt, int cluster,
                                     int cols, int slots, int* out) {
  if (H % 4) return (int)cudaErrorInvalidValue;
  return gated::geometry<true, true>(
      plan_args(M, H, I, tile, group_in, spt, cluster, cols, slots), out);
}
