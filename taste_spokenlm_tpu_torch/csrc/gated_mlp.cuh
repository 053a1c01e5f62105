// The gated Llama MLP on quantized weights, one launch a call, for Hopper:
//   y = (act(x Wg sg) * (x Wu su)) Wd sd
// shared by csrc/fused_mlp.cu (int8 weights, per-channel scales) and
// csrc/fused_mlp_int4.cu (nibble-packed weights, per-(plane, group) scales,
// Wd packed per tile of BI rows of I).  See those headers for the layouts.
// With FFN = true the same kernels compute the conformer's plain FFN,
//   y = act(x W1 s1 + b1) W2 s2 + b2
// (W1, s1 in the places of Wg, sg; W2, s2 in those of Wd, sd): one
// first-projection matrix, b1 and the activation applied where the ranks
// meet, s2 (int8) and b2 where the output is written (the last block's
// slot-ordered sum where the plan leaves several slots).  Built for int8
// (csrc/fused_mlp.cu) and int4 (csrc/fused_mlp_int4.cu: W2 packed per
// tile as Wd, each (plane, group) partial scaled on its own, so no s2 at
// the end).
//
// Bound on the H100: the weight bytes (the Llama-1B MLP: 50.3 MB int8, or
// 25.2 MB of nibbles and 1.6 MB of scales, about 15 / 8 us at 3.35 TB/s;
// the S3 stack's 6.3 / 3.3 MB).  Both kernels share one plan:
//   * a CLUSTER of C blocks owns a range of I (int4: a range of Wd's packed
//     rows, each pairing a low- and a high-plane column of I).  Rank c
//     forms the first projection over its KC rows of the contraction for
//     all the cluster's columns; the ranks' f32 partials meet in
//     distributed shared memory and each rank adds them in rank order into
//     a = bf16(act(g) * u).  Rank c then multiplies a by the cluster's rows
//     of Wd for its own output columns;
//   * the S clusters' partials [S, M, H] are summed by the last block to
//     arrive on its (row tile, rank) counter (an integer atomic, which it
//     resets to 0), in slot order, and scaled.  No float atomics: two calls
//     give the same bits.  The counters persist between calls, so calls
//     that share them run on one stream (graph replays ordered with them);
//   * no int-to-float conversion: an int8 or a nibble becomes a float by a
//     byte permute into the mantissa of 2^23 and one subtraction (SIMT), or
//     two at a time a bf16 pair by bit operations and one bf16x2
//     subtraction (tensor cores): (0x4300 | low 7 bits) - (0x4300 | sign
//     bit) for an int8, (0x4300 | (n ^ 8)) - 136 for a nibble; all exact;
//   * int4 scales each (plane, group) partial on its own, as `_dot_int4`.
// One row (a decode step, gated_gemv_kernel): the clusters own balanced
// ranges of 16-column chunks (120 blocks on an H100, the SMs clusters of 8
// reach); each lane walks a contiguous run of rows in 16-byte loads, the
// next rows in flight while it computes, and the first rows of Wd go out
// before the ranks meet.  Several rows (gated_mlp_kernel): the products run
// on the tensor cores (mma.sync.m16n8k16 bf16 -> f32) in row tiles of 16
// whose blocks sit next to each other in the grid, so a tile's weights come
// from L2 after the first; weights stream by cp.async (16-byte lanes)
// through a ring of 16-row stages, ldmatrix.trans of a byte tile gives a
// lane the bytes (k, k+1) x (n, n+1), the pairs along k feed the B
// fragments of an even- and an odd-column mma; Wd streams through a second
// ring whose first stages go out before the ranks meet; int4 keeps one
// accumulator fragment per (plane, group), a group edge inside a k16 step
// splitting it into masked products.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gated {

namespace cg = cooperative_groups;

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int MT = 16;      // rows of x a block
constexpr int PAD = 16;     // bytes added to each shared row: ldmatrix's 8
                            // rows then fall on 8 distinct bank groups
constexpr int MAX_CLUSTER = 8;
constexpr int STAGES = 4;   // ring stages (Wg / Wu, and Wd)
constexpr size_t SMEM_MAX = 226 * 1024;   // of 227 KB: room for `last`

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (an integer
// division by a runtime divisor would convert through floating point)
struct FastDiv {
  uint32_t m;
  int l;
};

inline FastDiv make_fastdiv(int d) {
  int l = 0;
  while ((1u << l) < (uint32_t)d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - (uint64_t)d)) / d + 1;
  return FastDiv{(uint32_t)m, l};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)((__umulhi((uint32_t)n, f.m) + (uint32_t)n) >> f.l);
}

struct Args {
  const __nv_bfloat16* x;   // [M, H]
  const float* b1;          // FFN: [I]
  const float* b2;          // FFN: [H]
  const uint8_t* wg;        // int8 [H, I] / packed [H/2, I]
  const float* sg;          // [I] / [H/GIN, I]
  const uint8_t* wu;
  const float* su;
  const uint8_t* wd;        // int8 [I, H] / packed per tile [I/2, H]
  const float* sd;          // [H] / [I/BI * SPT, H]
  float* part;              // [S, M, H] (S > 1)
  float* out;               // [M, H]
  int* arrivals;            // [Z * C], zero between calls
  int M, H, I, act;
  int C, TS, slots;         // the plan
  int simt;                 // M = 1 on the SIMT units (gated_gemv_kernel):
  // its S clusters own balanced ranges of the n16 chunks, its ranks of the
  // h16 output chunks; lane grids CL1 x RL1 and CL2 x RL2, rows a lane
  // run1 / run2; TS / HC are then the largest ranges
  int n16, h16, CL1, RL1, CL2, RL2, run1, run2, n_g2;
  FastDiv sdiv, cdiv, cl1, cl2, bi2, spt2;
  int BI, GIN, SPT;         // int4
  // derived on the host
  int K1;       // contraction rows of the first projection (int4: packed)
  int KC;       // of them a rank, a multiple of 16
  int HC;       // output columns a rank, 128 * NC2
  int K2;       // second-projection rows a cluster: TS / R packed
  int S, Z;     // clusters along I, row tiles of 16
  int U;        // int4: clusters a tile of Wd
  int GMID;     // int4: packed rows per scale row of Wd
  int NG1, NG2; // int4: scale groups a rank / a cluster can touch
  int sc_smem;  // int4: scales staged in shared memory (else read from L2)
  int vec;      // H % 16 == 0: Wd and x rows take 16-byte copies
  int n_g1;     // int4: scale groups a plane of the first projection
  FastDiv gin, gmid, u;
  size_t smem;
};

enum Act { ACT_SILU = 0, ACT_RELU = 1, ACT_GELU_TANH = 2 };

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU_TANH) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(k * (v + 0.044715f * v * v * v)));
  }
  return v / (1.f + expf(-v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n groups are pending (n < 8)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// counter += 1 at GPU scope with acquire-release order; -> the old value
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <int LUT>
__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, %4;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c),
      "n"(LUT));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// bytes 0 and 2 of r (int8, two's complement) as two exact bf16 values:
// (0x4300 | low 7 bits) = 128 + l minus (0x4300 | sign bit) = 128 or 256
__device__ __forceinline__ uint32_t deq8(uint32_t r) {
  const uint32_t v = lop3<0xEA>(r, 0x007F007Fu, 0x43004300u);   // (a&b)|c
  const uint32_t s = lop3<0xEA>(r, 0x00800080u, 0x43004300u);
  return bf16x2_sub(v, s);
}

// the low nibbles of bytes 0 and 2 of r (two's complement) as two exact
// bf16 values: 0x4300 | (n ^ 8) = 136 + q, minus 136
__device__ __forceinline__ uint32_t deq4(uint32_t r) {
  // m ? (r ^ k) : k with m = 0x000F000F, k = 0x43084308
  const uint32_t v = lop3<0x6A>(r, 0x000F000Fu, 0x43084308u);
  return bf16x2_sub(v, 0x43084308u);
}

// keep the bf16 halves of a whose k index (k, k + 1) lies in [lo, hi)
__device__ __forceinline__ uint32_t keep(uint32_t a, int k, int lo, int hi) {
  return a & ((k >= lo && k < hi ? 0x0000FFFFu : 0u) |
              (k + 1 >= lo && k + 1 < hi ? 0xFFFF0000u : 0u));
}

// the A fragment restricted to k16-local indices [lo, hi)
__device__ __forceinline__ void mask_a(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       int lo, int hi, int t) {
  d[0] = keep(a[0], 2 * t, lo, hi);
  d[1] = keep(a[1], 2 * t, lo, hi);
  d[2] = keep(a[2], 2 * t + 8, lo, hi);
  d[3] = keep(a[3], 2 * t + 8, lo, hi);
}

// one k16 step of a warp against NC 16-column chunks of a byte tile: the B
// fragments of chunk j (b[j], from ldmatrix.trans) made bf16 and multiplied
// by the A fragment, even and odd columns into acc[j][0] / [1].  Q4 takes
// the low nibbles (shift 0) or the high ones (shift 4).
template <bool Q4, int NC>
__device__ __forceinline__ void step_products(float (&acc)[NC][2][4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[NC][2],
                                              int shift) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const uint32_t r0 = b[j][0] >> shift, r1 = b[j][1] >> shift;
    uint32_t e0, e1, o0, o1;
    if constexpr (Q4) {
      e0 = deq4(r0); e1 = deq4(r1); o0 = deq4(r0 >> 8); o1 = deq4(r1 >> 8);
    } else {
      e0 = deq8(r0); e1 = deq8(r1); o0 = deq8(r0 >> 8); o1 = deq8(r1 >> 8);
    }
    mma(acc[j][0], a, e0, e1);
    mma(acc[j][1], a, o0, o1);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][2][4]) {
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][e][i] = 0.f;
}

// the column (0..3 within the lane's quad 4t..4t+3) of fragment (e, i):
// even mma e = 0 holds columns 4t, 4t + 2, odd e = 1 columns 4t + 1, 4t + 3
__device__ __forceinline__ int quad_col(int e, int i) {
  return e + 2 * (i & 1);
}

// total += lo * s_lo + hi * s_hi per column; s_*(j, q) gives the scale of
// column q of the lane's quad in chunk j
template <int NC, class SL, class SH>
__device__ __forceinline__ void flush(float (&tot)[NC][2][4],
                                      float (&lo)[NC][2][4],
                                      float (&hi)[NC][2][4], SL s_lo, SH s_hi) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float sl[4], sh[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sl[q] = s_lo(j, q);
      sh[q] = s_hi(j, q);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = quad_col(e, i);
        tot[j][e][i] += lo[j][e][i] * sl[q] + hi[j][e][i] * sh[q];
        lo[j][e][i] = hi[j][e][i] = 0.f;
      }
  }
}

// the four columns 4t..4t+3 of chunk j, row g + 8 h
template <int NC>
__device__ __forceinline__ float4 quad(const float (&acc)[NC][2][4], int j,
                                       int h) {
  return make_float4(acc[j][0][2 * h], acc[j][1][2 * h], acc[j][0][2 * h + 1],
                     acc[j][1][2 * h + 1]);
}

// NC1 16-column chunks a warp in the first projection (TS = 128 NC1), NC2
// in the second (HC = 128 NC2)
template <bool Q4, bool FFN, int NC1, int NC2>
__global__ void __launch_bounds__(THREADS, 1) gated_mlp_kernel(const Args g) {
  constexpr int MATS = FFN ? 1 : 2;           // first-projection matrices
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;     // mma group, thread in group
  constexpr int TS = 128 * NC1, HC = 128 * NC2;  // == g.TS, g.HC
  const int C = g.C, KC = g.KC;
  const int c = blockIdx.x;                   // rank in the cluster
  const int z = blockIdx.y;                   // row tile
  const int s = blockIdx.z;                   // cluster along I
  const int m0 = z * MT, rows = min(MT, g.M - m0);
  const int R = TS / 2;                       // int4: packed rows a cluster
  // the cluster's columns of I: int8 [col0, col0 + TS); int4 tile t4, its
  // packed rows [r0, r0 + R) and the two runs they pair
  const int t4 = Q4 ? fdiv(s, g.u) : 0, r0 = Q4 ? (s - t4 * g.U) * R : 0;
  const int col0 = Q4 ? t4 * g.BI + r0 : s * TS;
  const int run_valid = Q4 ? min(R, g.BI / 2 - r0) : min(TS, g.I - col0);
  const int kb = c * KC, ke = min(kb + KC, g.K1);   // the rank's rows
  const int hb = c * HC;                           // the rank's out columns

  // shared memory
  const int XK = Q4 ? 2 * KC : KC;            // x columns a rank reads
  const int xs_ld = XK * 2 + PAD, as_ld = TS * 2 + PAD;
  const int w1_ld = TS + PAD, w2_ld = HC + PAD;
  const int K2r = (g.K2 + 15) & ~15;
  constexpr int SB = STAGES;                             // Wd ring slots
  uint8_t* xs = smem;                                    // [MT][XK] bf16
  uint8_t* as = xs + MT * xs_ld;                         // [MT][TS] bf16
  uint8_t* w2s = as + MT * as_ld;                        // SB x [16][HC] bytes
  uint8_t* ring = w2s + (size_t)SB * 16 * w2_ld;         // stages x MATS x 16 rows
  const size_t stage_bytes = MATS * 16 * (size_t)w1_ld;
  const size_t pf_bytes = (size_t)MATS * MT * TS * sizeof(float);
  const size_t ring_bytes = STAGES * stage_bytes > pf_bytes
                                ? STAGES * stage_bytes : pf_bytes;
  float* pf = reinterpret_cast<float*>(ring);            // [MATS][MT][TS], later
  float* sc = reinterpret_cast<float*>(ring + ring_bytes);
  // int8: sc = sg [TS], su [TS], sd [HC] (FFN: s1 [TS], b1 [TS], s2 [HC],
  // b2 [HC]); int4 (staged): sc1 [MATS][2 planes][NG1][TS], sc2 [2
  // planes][NG2][HC] (FFN: then b1 [TS], b2 [HC])
  float* sc2 = sc + MATS * 2 * g.NG1 * TS;                // int4
  float* b1_4 = sc2 + 2 * g.NG2 * HC;                     // int4 FFN
  float* b2_4 = b1_4 + TS;
  const int g1_first = Q4 ? fdiv(kb, g.gin) : 0;
  const int g2_first = Q4 ? fdiv(r0, g.gmid) : 0;

  // ---- staging: x and the scales, then the ring's first stages ----
  const int n1 = KC / 16;                                // k16 steps, phase 1
  const int n2 = K2r / 16;                               // k16 steps, phase 2
  // the phase-1 step from which no Wg / Wu stage is left to issue: it
  // issues the first SB stages of Wd, in flight through the exchange
  const int kstar = max(0, n1 - STAGES + 1);
  auto col_ok = [&](int jc) -> bool {                    // inside I / the tile
    return (Q4 ? jc % R : jc) < run_valid;
  };
  auto w1_col = [&](int jc) -> int {                     // cluster col -> I col
    if (!Q4) return col0 + jc;
    return jc < R ? col0 + jc : col0 + g.BI / 2 + (jc - R);
  };
  // a stage: 16 rows of Wg and Wu (FFN: of W1; NC1 16-byte copies a
  // thread, at fixed offsets that step down 16 rows a stage)
  const uint8_t* p1src[NC1];
  int p1dst[NC1], p1k[NC1];
  bool p1ok[NC1], p1on[NC1];
#pragma unroll
  for (int j = 0; j < NC1; ++j) {
    const int i = tid + j * THREADS, mat = i / TS, rr = (i % TS) / (TS / 16);
    const int jc = (i % (TS / 16)) * 16;
    p1on[j] = mat < MATS;
    p1k[j] = kb + rr;
    p1ok[j] = col_ok(jc);
    p1src[j] = (mat ? g.wu : g.wg) + (long long)p1k[j] * g.I + w1_col(jc);
    p1dst[j] = (mat * 16 + rr) * w1_ld + jc;
  }
  const long long step_bytes = 16LL * g.I;
  const uint8_t* wd0 =
      g.wd + (Q4 ? (long long)t4 * (g.BI / 2) + r0 : (long long)col0) * g.H + hb;
  auto issue = [&](int step, int slot) {
    if (step < n1) {
      uint8_t* dst = ring + (size_t)slot * stage_bytes;
#pragma unroll
      for (int j = 0; j < NC1; ++j) {
        if (!p1on[j]) continue;
        const bool ok = p1ok[j] && p1k[j] + 16 * step < ke;
        cp_async16(dst + p1dst[j], ok ? p1src[j] + step * step_bytes : g.wg,
                   ok ? 16 : 0);
      }
    }
  };
  // a Wd stage: rows [16 j, 16 j + 16) of the cluster's K2, the rank's HC
  // columns
  auto issue_wd = [&](int j, int slot) {
    if (j < n2) {
      uint8_t* dst = w2s + (size_t)slot * 16 * w2_ld;
      for (int e = tid; e < HC; e += THREADS) {
        const int rr = e / (HC / 16), jc = (e % (HC / 16)) * 16;
        const int row = 16 * j + rr;
        const int nb = row < run_valid ? min(16, max(0, g.H - hb - jc)) : 0;
        uint8_t* d = dst + rr * w2_ld + jc;
        const uint8_t* src = wd0 + (long long)row * g.H + jc;
        if (g.vec) {
          cp_async16(d, nb ? src : g.wd, nb);
        } else {
          for (int b = 0; b < 16; ++b) d[b] = b < nb ? __ldg(src + b) : (uint8_t)0;
        }
      }
    }
  };
  // a = 0 (rows past M stay 0); x rows [m0, m0 + rows) of the rank's
  // columns (int4: the low plane's KC, then the high plane's) and the
  // scales ride with the first stage
  for (int i = tid; i < MT * (TS / 8); i += THREADS)
    *reinterpret_cast<uint4*>(as + (i / (TS / 8)) * as_ld + (i % (TS / 8)) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  for (int m = rows; m < MT; ++m)
    for (int kk = tid * 8; kk < XK; kk += THREADS * 8)
      *reinterpret_cast<uint4*>(xs + m * xs_ld + kk * 2) = make_uint4(0u, 0u, 0u, 0u);
  for (int m = 0; m < rows; ++m) {
    uint8_t* xrow = xs + m * xs_ld;
    const __nv_bfloat16* src = g.x + (long long)(m0 + m) * g.H;
    if (g.vec) {                  // 8 columns a copy, all in or all out
      for (int kk = tid * 8; kk < XK; kk += THREADS * 8) {
        const int k = kb + (Q4 && kk >= KC ? kk - KC : kk);
        const int col = (Q4 && kk >= KC ? g.H / 2 : 0) + k;
        const bool ok = k < ke;
        cp_async16(xrow + kk * 2, ok ? src + col : g.x, ok ? 16 : 0);
      }
    } else {
      for (int kk = tid; kk < XK; kk += THREADS) {
        const int k = kb + (Q4 && kk >= KC ? kk - KC : kk);
        const int col = (Q4 && kk >= KC ? g.H / 2 : 0) + k;
        reinterpret_cast<__nv_bfloat16*>(xrow)[kk] =
            k < ke ? src[col] : __float2bfloat16(0.f);
      }
    }
  }
  // the scales, 4 a copy (runs of columns are multiples of 16, H of 4)
  if (!Q4) {
    for (int i = tid * 4; i < 2 * TS + (FFN ? 2 : 1) * HC; i += THREADS * 4) {
      const float* src = g.sg;
      bool ok;
      if (i < 2 * TS) {
        const int jc = i & (TS - 1);
        ok = jc < run_valid;
        src = (i < TS ? g.sg : FFN ? g.b1 : g.su) + col0 + jc;
      } else {
        const int jc = (i - 2 * TS) & (HC - 1);
        ok = hb + jc < g.H;
        src = (i < 2 * TS + HC ? g.sd : g.b2) + hb + jc;
      }
      cp_async16(sc + i, ok ? src : g.sg, ok ? 16 : 0);
    }
  } else if (g.sc_smem) {
    for (int row = 0, mat = 0, p = 0, gi = 0; row < MATS * 2 * g.NG1; ++row) {
      const int grp = g1_first + gi;                   // row (mat, p, gi)
      for (int jc = tid * 4; jc < TS; jc += THREADS * 4) {
        const bool ok = grp < g.n_g1 && col_ok(jc);
        const float* src = (mat ? g.su : g.sg) +
                           (long long)(p * g.n_g1 + grp) * g.I + w1_col(jc);
        cp_async16(sc + row * TS + jc, ok ? src : g.sg, ok ? 16 : 0);
      }
      if (++gi == g.NG1) {
        gi = 0;
        if (++p == 2) p = 0, ++mat;
      }
    }
    for (int row = 0; row < 2 * g.NG2; ++row) {        // (plane, group)
      const int p = row >= g.NG2, grp = g2_first + row - p * g.NG2;
      for (int jc = tid * 4; jc < HC; jc += THREADS * 4) {
        const bool ok = grp < g.SPT / 2 && hb + jc < g.H;
        const float* src =
            g.sd + (long long)(t4 * g.SPT + p * (g.SPT / 2) + grp) * g.H + hb + jc;
        cp_async16(sc2 + row * HC + jc, ok ? src : g.sd, ok ? 16 : 0);
      }
    }
    if (FFN) {        // b1 of the cluster's two runs, b2 of the rank's columns
      for (int jc = tid * 4; jc < TS; jc += THREADS * 4) {
        const bool ok = col_ok(jc);
        cp_async16(b1_4 + jc, ok ? g.b1 + w1_col(jc) : g.b1, ok ? 16 : 0);
      }
      for (int jc = tid * 4; jc < HC; jc += THREADS * 4) {
        const bool ok = hb + jc < g.H;
        cp_async16(b2_4 + jc, ok ? g.b2 + hb + jc : g.b2, ok ? 16 : 0);
      }
    }
  }
  for (int st = 0; st < STAGES - 1; ++st) {
    issue(st, st);
    cp_commit();
  }
  int rd_slot = 0, wr_slot = STAGES - 1;

  // ---- first projection: warp w owns columns [w * 16 NC1, ...) ----
  float tg[NC1][2][4], tu[NC1][2][4];
  float lg[NC1][2][4], hg[NC1][2][4], lu[NC1][2][4], hu[NC1][2][4];
  zero(tg); zero(tu);
  if constexpr (Q4) { zero(lg); zero(hg); zero(lu); zero(hu); }
  const int wc0 = warp * 16 * NC1;
  // the scale of quad column q of chunk j, plane p, group grp (first
  // projection, matrix mat)
  auto s1 = [&](int mat, int p, int grp, int j, int q) -> float {
    const int jc = wc0 + 16 * j + 4 * t + q;
    if (g.sc_smem)
      return sc[((mat * 2 + p) * g.NG1 + grp - g1_first) * TS + jc];
    if (!col_ok(jc)) return 0.f;
    return __ldg((mat ? g.su : g.sg) + (long long)(p * g.n_g1 + grp) * g.I +
                 w1_col(jc));
  };
  auto flush1 = [&](int grp) {
    flush(tg, lg, hg, [&](int j, int q) { return s1(0, 0, grp, j, q); },
          [&](int j, int q) { return s1(0, 1, grp, j, q); });
    if constexpr (!FFN)
      flush(tu, lu, hu, [&](int j, int q) { return s1(1, 0, grp, j, q); },
            [&](int j, int q) { return s1(1, 1, grp, j, q); });
  };
  // int4 FFN: b1 of cluster column jc
  auto b1_at = [&](int jc) -> float {
    if (g.sc_smem) return b1_4[jc];
    return col_ok(jc) ? __ldg(g.b1 + w1_col(jc)) : 0.f;
  };
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  for (int step = 0; step < n1; ++step) {
    cp_wait(STAGES - 2);
    __syncthreads();
    issue(step + STAGES - 1, wr_slot);
    if (step == kstar)
      for (int j = 0; j < SB; ++j) issue_wd(j, j);
    cp_commit();
    wr_slot = wr_slot + 1 == STAGES ? 0 : wr_slot + 1;
    const uint8_t* slot = ring + (size_t)rd_slot * stage_bytes;
    rd_slot = rd_slot + 1 == STAGES ? 0 : rd_slot + 1;
    uint32_t bg[NC1][2], bu[NC1][2];
#pragma unroll
    for (int j = 0; j < NC1; ++j) {
      ldsm_x2_t(bg[j], slot + (lane & 15) * w1_ld + wc0 + 16 * j);
      if constexpr (!FFN)
        ldsm_x2_t(bu[j], slot + (16 + (lane & 15)) * w1_ld + wc0 + 16 * j);
    }
    const int k0 = step * 16;
    uint32_t a_lo[4];
    ldsm_x4(a_lo, xs + a_row * xs_ld + (k0 + a_col) * 2);
    if constexpr (!Q4) {
      step_products<false>(tg, a_lo, bg, 0);
      if constexpr (!FFN) step_products<false>(tu, a_lo, bu, 0);
    } else {
      uint32_t a_hi[4];
      ldsm_x4(a_hi, xs + a_row * xs_ld + (KC + k0 + a_col) * 2);
      // segments of the step inside one scale group
      const int kg0 = kb + k0, kend = min(kg0 + 16, ke);
      for (int lo = kg0; lo < kend;) {
        const int grp = fdiv(lo, g.gin);
        const int hi = min(kend, (grp + 1) * g.GIN);
        if (lo == kg0 && hi == kg0 + 16) {
          step_products<true>(lg, a_lo, bg, 0);
          step_products<true>(hg, a_hi, bg, 4);
          if constexpr (!FFN) {
            step_products<true>(lu, a_lo, bu, 0);
            step_products<true>(hu, a_hi, bu, 4);
          }
        } else {
          uint32_t ml[4], mh[4];
          mask_a(ml, a_lo, lo - kg0, hi - kg0, t);
          mask_a(mh, a_hi, lo - kg0, hi - kg0, t);
          step_products<true>(lg, ml, bg, 0);
          step_products<true>(hg, mh, bg, 4);
          if constexpr (!FFN) {
            step_products<true>(lu, ml, bu, 0);
            step_products<true>(hu, mh, bu, 4);
          }
        }
        if (hi == (grp + 1) * g.GIN || hi == ke) flush1(grp);
        lo = hi;
      }
    }
  }
  __syncthreads();   // every warp is done with the ring

  // ---- the ranks' partials meet in distributed shared memory ----
  // pf[mat][row][col]: rows g + 8 h, columns wc0 + 16 j + 4 t + q
#pragma unroll
  for (int j = 0; j < NC1; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gq + 8 * h, jc = wc0 + 16 * j + 4 * t;
      *reinterpret_cast<float4*>(pf + row * TS + jc) = quad(tg, j, h);
      if constexpr (!FFN)
        *reinterpret_cast<float4*>(pf + (MT + row) * TS + jc) = quad(tu, j, h);
    }
  cluster.sync();
  // a = bf16(act(g) u) (FFN: bf16(act(g s1 + b1)), int4 g already
  // scaled), row m, columns [j0, j0 + 4): the ranks' partials added in rank
  // order
  for (int i = tid; i < rows * (TS / 4); i += THREADS) {
    const int m = i / (TS / 4), j0 = (i % (TS / 4)) * 4;
    float4 pa[MAX_CLUSTER], pb[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) {
        const float* pr = cluster.map_shared_rank(pf, r);
        pa[r] = *reinterpret_cast<const float4*>(pr + m * TS + j0);
        if constexpr (!FFN)
          pb[r] = *reinterpret_cast<const float4*>(pr + (MT + m) * TS + j0);
      }
    float4 gs = make_float4(0.f, 0.f, 0.f, 0.f), us = gs;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) {
        gs.x += pa[r].x; gs.y += pa[r].y; gs.z += pa[r].z; gs.w += pa[r].w;
        if constexpr (!FFN) {
          us.x += pb[r].x; us.y += pb[r].y; us.z += pb[r].z; us.w += pb[r].w;
        }
      }
    const float gv[4] = {gs.x, gs.y, gs.z, gs.w}, uv[4] = {us.x, us.y, us.z, us.w};
    __nv_bfloat16* arow = reinterpret_cast<__nv_bfloat16*>(as + m * as_ld);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float gval = gv[q], uval = uv[q];
      if (FFN) {
        const float pre = Q4 ? gval + b1_at(j0 + q)
                             : gval * sc[j0 + q] + sc[TS + j0 + q];
        arow[j0 + q] = __float2bfloat16(act_fn(pre, g.act));
        continue;
      }
      if (!Q4) {
        gval *= sc[j0 + q];
        uval *= sc[TS + j0 + q];
      }
      arow[j0 + q] = __float2bfloat16(act_fn(gval, g.act) * uval);
    }
  }
  // done reading the other ranks' shared memory; they may exit once every
  // rank has arrived (waited for at the end)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  // ---- second projection: the cluster's K2 rows, this rank's HC columns;
  // warp w owns 16-column chunks w, w + 8, ... ----
  float acc[NC2][2][4], lo2[NC2][2][4], hi2[NC2][2][4];
  zero(acc);
  if constexpr (Q4) { zero(lo2); zero(hi2); }
  auto s2 = [&](int p, int grp, int j, int q) -> float {
    const int jc = (warp + 8 * j) * 16 + 4 * t + q;
    if (g.sc_smem) return sc2[(p * g.NG2 + grp - g2_first) * HC + jc];
    if (hb + jc >= g.H) return 0.f;
    return __ldg(g.sd + (long long)(t4 * g.SPT + p * (g.SPT / 2) + grp) * g.H +
                 hb + jc);
  };
  const int k2_end = Q4 ? r0 + run_valid : run_valid;  // packed rows / rows
  for (int i = 0, b_rd = 0, b_wr = 0; i < n2; ++i) {
    // stage i's group: issued at step kstar (i < SB) or at phase-2 step
    // i - SB + 1; one group committed every step of either phase
    const int pending = i < SB ? n1 + i - 1 - kstar : SB - 2;
    cp_wait(pending < 6 ? pending : 6);
    __syncthreads();
    if (i >= 1) {                     // refill the slot stage i - 1 freed
      issue_wd(i - 1 + SB, b_wr);
      b_wr = b_wr + 1 == SB ? 0 : b_wr + 1;
    }
    cp_commit();
    const uint8_t* slot = w2s + (size_t)b_rd * 16 * w2_ld;
    b_rd = b_rd + 1 == SB ? 0 : b_rd + 1;
    const int k0 = 16 * i;
    uint32_t b[NC2][2];
#pragma unroll
    for (int j = 0; j < NC2; ++j)
      ldsm_x2_t(b[j], slot + (lane & 15) * w2_ld + (warp + 8 * j) * 16);
    uint32_t a_lo[4];
    ldsm_x4(a_lo, as + a_row * as_ld + (k0 + a_col) * 2);
    if constexpr (!Q4) {
      step_products<false>(acc, a_lo, b, 0);
    } else {
      uint32_t a_hi[4];
      ldsm_x4(a_hi, as + a_row * as_ld + (R + k0 + a_col) * 2);
      const int kg0 = r0 + k0, kend = min(kg0 + 16, k2_end);
      for (int lo = kg0; lo < kend;) {
        const int grp = fdiv(lo, g.gmid);
        const int hi = min(kend, (grp + 1) * g.GMID);
        if (lo == kg0 && hi == kg0 + 16) {
          step_products<true>(lo2, a_lo, b, 0);
          step_products<true>(hi2, a_hi, b, 4);
        } else {
          uint32_t ml[4], mh[4];
          mask_a(ml, a_lo, lo - kg0, hi - kg0, t);
          mask_a(mh, a_hi, lo - kg0, hi - kg0, t);
          step_products<true>(lo2, ml, b, 0);
          step_products<true>(hi2, mh, b, 4);
        }
        if (hi == (grp + 1) * g.GMID || hi == k2_end)
          flush(acc, lo2, hi2, [&](int j, int q) { return s2(0, grp, j, q); },
                [&](int j, int q) { return s2(1, grp, j, q); });
        lo = hi;
      }
    }
  }

  // ---- the clusters' partials: one slot each, summed by the last block ----
  const float* sd_s = sc + 2 * TS;     // int8: sd of the rank's columns
  // int8: v sd (FFN: v s2 + b2), int4: v (FFN: v + b2), the output of
  // columns [jc, jc + 4)
  auto finish = [&](float4& v, int jc) {
    if (!Q4) {
      v.x *= sd_s[jc]; v.y *= sd_s[jc + 1];
      v.z *= sd_s[jc + 2]; v.w *= sd_s[jc + 3];
    }
    if (FFN) {
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = !Q4 ? sd_s[HC + jc + q]
               : g.sc_smem ? b2_4[jc + q] : __ldg(g.b2 + hb + jc + q);
      v.x += b[0]; v.y += b[1]; v.z += b[2]; v.w += b[3];
    }
  };
#pragma unroll
  for (int j = 0; j < NC2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = gq + 8 * h, jc = (warp + 8 * j) * 16 + 4 * t;
      if (row >= rows || hb + jc >= g.H) continue;
      float4 v = quad(acc, j, h);
        if (g.S == 1) {
          finish(v, jc);
          *reinterpret_cast<float4*>(g.out + (long long)(m0 + row) * g.H + hb + jc) = v;
        } else {
          *reinterpret_cast<float4*>(
              g.part + ((long long)s * g.M + m0 + row) * g.H + hb + jc) = v;
        }
      }
  if (g.S > 1) {
    __shared__ int last;
    __syncthreads();
    int* counter = g.arrivals + z * C + c;
    const int cols = min(HC, g.H - hb);
    // the block's partials (ordered before by the barrier) are released,
    // and the other blocks' acquired, by one acq_rel atomic
    if (tid == 0) last = arrive(counter) == g.S - 1;
    __syncthreads();
    if (last) {
      // the sums of the S slots, in slot order, scaled: items (row, 4
      // columns) over all the block's threads, 8 slots in flight
      constexpr int Q = HC / 4;
      const long long slot = (long long)g.M * g.H;
      for (int i = tid; i < rows * Q; i += THREADS) {
        const int m = i / Q, jc = (i % Q) * 4;
        if (jc >= cols) continue;
        const float* p = g.part + (long long)(m0 + m) * g.H + hb + jc;
        float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s0 = 0; s0 < g.S; s0 += 8) {
          float4 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (s0 + q < g.S)
              v[q] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + q) * slot));
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (s0 + q < g.S) {
              tot.x += v[q].x; tot.y += v[q].y; tot.z += v[q].z; tot.w += v[q].w;
            }
        }
        finish(tot, jc);
        *reinterpret_cast<float4*>(g.out + (long long)(m0 + m) * g.H + hb + jc) = tot;
      }
      if (tid == 0) *counter = 0;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// one row of x (a decode step): the same clusters, exchange and last-block
// sum, with the products on the SIMT units
// ---------------------------------------------------------------------------

// byte j of v as an exact float: v holds a biased byte b (int8: q + 128,
// from w ^ 0x80808080; a nibble: q + 8, from (w & 0x0F0F0F0F) ^ 0x08080808),
// which goes into the mantissa of 2^23, and 2^23 + the bias comes off
__device__ __forceinline__ float byte_f(uint32_t v, int j, float bias) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + j)) - bias;
}
constexpr float BIAS8 = 8388736.f, BIAS4 = 8388616.f;   // 2^23 + 128 / + 8

__device__ __forceinline__ uint4 ldg16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[4 i + j] += xv * (byte j of word i) for the 16 bytes of w (int8), or
// of their low / high nibbles (Q4, shift 0 / 4)
template <bool Q4>
__device__ __forceinline__ void fma16(float (&acc)[16], float xv, const uint4& w,
                                      int shift) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = Q4 ? ((words[i] >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u
                          : words[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[4 * i + j] = fmaf(xv, byte_f(v, j, Q4 ? BIAS4 : BIAS8), acc[4 * i + j]);
  }
}

// tot += lo * s_lo + hi * s_hi over 16 columns; lo, hi = 0
__device__ __forceinline__ void flush16(float (&tot)[16], float (&lo)[16],
                                        float (&hi)[16], const float* s_lo,
                                        const float* s_hi) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    tot[q] += lo[q] * s_lo[q] + hi[q] * s_hi[q];
    lo[q] = hi[q] = 0.f;
  }
}

// M = 1.  Cluster s owns a balanced range of 16-column chunks (int4: of
// 16-packed-row chunks of Wd, each pairing a low and a high run of columns,
// in any tile); rank c forms the first projection over its KC rows of the
// contraction for all the cluster's columns, lane (rl, cl) walking a
// contiguous run of rows in 16-byte loads, U rows in flight, then the second
// over the cluster's rows of Wd for its own balanced range of output
// columns.  The host sets the lane grids (g.CL1 x g.RL1, g.CL2 x g.RL2).
template <bool Q4, bool FFN>
__global__ void __launch_bounds__(THREADS) gated_gemv_kernel(const Args g) {
  constexpr int MATS = FFN ? 1 : 2;   // first-projection matrices
  // rows of a lane in flight, phase 1 and 2: the int4 FFN's lanes walk 3
  // rows at the S3 shape, and its shorter unrolled loops are faster there
  constexpr int U1 = Q4 && FFN ? 2 : 4, U = Q4 && FFN ? 4 : 8;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int C = g.C, KC = g.KC;
  // every rank has started before another writes into its shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int c = blockIdx.x, s = blockIdx.z;
  // the cluster's chunks [q0, q1): int8 columns 16 q0.., int4 packed rows
  const int q0 = fdiv(s * g.n16, g.sdiv), q1 = fdiv((s + 1) * g.n16, g.sdiv);
  const int R = 16 * (q1 - q0);                 // int8: columns; int4: rows
  const int TSc = Q4 ? 2 * R : R;               // first-projection columns
  const int p0 = 16 * q0;
  const int kb = c * KC, ke = min(kb + KC, g.K1);
  const int h0 = fdiv(c * g.h16, g.cdiv), h1 = fdiv((c + 1) * g.h16, g.cdiv);
  const int hb = 16 * h0, HCc = 16 * (h1 - h0);
  const int XK = Q4 ? 2 * KC : KC, TSM = g.TS, HCM = g.HC;
  // cluster column jc (a multiple of 16) -> column of I
  auto w1_col = [&](int jc) -> int {
    if (!Q4) return p0 + jc;
    const int pr = p0 + (jc < R ? jc : jc - R);
    const int t = fdiv(pr, g.bi2);
    return t * g.BI + (jc < R ? 0 : g.BI / 2) + pr - t * (g.BI / 2);
  };

  // shared memory: x [XK], the row lanes' sums [MATS][RL1][TSM] (phase 2:
  // [RL2][HCM]), every rank's partials [C][MATS][TSM], a [TSM], the scales
  // (int8: sg, su [TSM] and sd [HCM]; FFN: s1, b1 [TSM], s2, b2 [HCM];
  // int4: [MATS][2 planes][NG1][TSM], FFN: b1 [TSM], then [2][NG2][HCM],
  // FFN: b2 [HCM])
  float* xs = reinterpret_cast<float*>(smem);
  float* red = xs + XK;
  const int RED = MATS * g.RL1 * TSM > g.RL2 * HCM ? MATS * g.RL1 * TSM
                                                   : g.RL2 * HCM;
  float* pf = red + RED;
  float* av = pf + MATS * TSM * C;
  float* sc = av + TSM;
  float* b1s = sc + (Q4 ? MATS * 2 * g.NG1 * TSM : TSM);
  float* sc2 = Q4 ? b1s + (FFN ? TSM : 0) : sc + 2 * TSM;
  float* b2s = sc2 + (Q4 ? 2 * g.NG2 * HCM : HCM);
  const int g1_first = Q4 ? fdiv(kb, g.gin) : 0;
  const int g2_first = Q4 ? fdiv(p0, g.gmid) : 0;

  // phase 1's lanes: (rl, cl) walks rows [r1, r1e) of the rank, 16 columns;
  // its first rows go out before x and the scales are staged
  const int rl = fdiv(tid, g.cl1), cl = tid - rl * g.CL1, jc1 = 16 * cl;
  const bool on1 = rl < g.RL1 && jc1 < TSc;
  const int r1 = kb + rl * g.run1, r1e = on1 ? min(r1 + g.run1, ke) : r1;
  const uint8_t* pg = g.wg + (on1 ? w1_col(jc1) : 0);
  const uint8_t* pu = g.wu + (on1 ? w1_col(jc1) : 0);
  uint4 ng[U1], nu[U1];                  // the next rows of Wg and Wu
  auto load1 = [&](int r) {
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      const bool ok = r + u < r1e;
      ng[u] = ok ? ldg16(pg + (long long)(r + u) * g.I) : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (!FFN)
        nu[u] = ok ? ldg16(pu + (long long)(r + u) * g.I) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // the scales (4 a copy: runs are multiples of 16 columns, H of 16) go
  // first, then the first rows of Wg / Wu, then x (all loads, then stores)
  if (!Q4) {
    for (int i = tid * 4; i < 2 * TSM; i += THREADS * 4) {
      const int jc = i < TSM ? i : i - TSM;
      const bool ok = jc < TSc;
      const float* second = FFN ? g.b1 : g.su;
      cp_async16(sc + i, ok ? (i < TSM ? g.sg : second) + p0 + jc : g.sg,
                 ok ? 16 : 0);
    }
    for (int jc = tid * 4; jc < HCc; jc += THREADS * 4) {
      cp_async16(sc2 + jc, g.sd + hb + jc, 16);
      if (FFN) cp_async16(sc2 + HCM + jc, g.b2 + hb + jc, 16);
    }
  } else {
    // only the groups that the rank's rows (ng1) and the cluster's rows of
    // Wd (ng2) touch: each staged copy costs time at decode; NG1 / NG2 size
    // the room for the most
    const int ng1 = ke > kb ? fdiv(ke - 1, g.gin) - g1_first + 1 : 0;
    const int ng2 = fdiv(p0 + R - 1, g.gmid) - g2_first + 1;
    for (int row = 0, mat = 0, p = 0, gi = 0; row < MATS * 2 * g.NG1; ++row) {
      const int grp = g1_first + gi;               // row (mat, p, gi)
      for (int jc = tid * 4; gi < ng1 && jc < TSc; jc += THREADS * 4) {
        const bool ok = grp < g.n_g1;
        const float* src = (mat ? g.su : g.sg) +
                           (long long)(p * g.n_g1 + grp) * g.I + w1_col(jc & ~15) +
                           (jc & 15);
        cp_async16(sc + row * TSM + jc, ok ? src : g.sg, ok ? 16 : 0);
      }
      if (++gi == g.NG1) {
        gi = 0;
        if (++p == 2) p = 0, ++mat;
      }
    }
    // Wd's groups: global packed-row group gg, in tile gg / (SPT/2)
    for (int row = 0; row < 2 * g.NG2; ++row) {        // (plane, group)
      const int p = row >= g.NG2, gg = g2_first + row - p * g.NG2;
      if (gg - g2_first >= ng2) continue;
      const int t = fdiv(gg, g.spt2);
      const bool ok = gg < g.n_g2;
      const float* src = g.sd + (long long)(t * g.SPT + p * (g.SPT / 2) + gg -
                                            t * (g.SPT / 2)) * g.H + hb;
      for (int jc = tid * 4; jc < HCc; jc += THREADS * 4)
        cp_async16(sc2 + row * HCM + jc, ok ? src + jc : g.sd, ok ? 16 : 0);
    }
    if (FFN) {        // b1 of the cluster's columns (its 16-row chunks'
                      // runs), b2 of the rank's
      for (int jc = tid * 4; jc < TSc; jc += THREADS * 4)
        cp_async16(b1s + jc, g.b1 + w1_col(jc & ~15) + (jc & 15), 16);
      for (int jc = tid * 4; jc < HCc; jc += THREADS * 4)
        cp_async16(b2s + jc, g.b2 + hb + jc, 16);
    }
  }
  cp_commit();
  load1(r1);
  for (int k0 = 0; k0 < XK; k0 += 8 * THREADS) {
    __nv_bfloat16 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kk = k0 + tid + i * THREADS;
      const int k = kb + (Q4 && kk >= KC ? kk - KC : kk);
      const int col = (Q4 && kk >= KC ? g.H / 2 : 0) + k;
      xv[i] = kk < XK && k < ke ? g.x[col] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k0 + tid + i * THREADS < XK) xs[k0 + tid + i * THREADS] = __bfloat162float(xv[i]);
  }
  cp_wait(0);
  __syncthreads();

  // ---- phase 1: U1 rows computed while the next U1 are in flight ----
  float tg[16], tu[16], lg[16], hg[16], lu[16], hu[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) tg[q] = tu[q] = lg[q] = hg[q] = lu[q] = hu[q] = 0.f;
  int grp = Q4 ? fdiv(r1, g.gin) : 0, g_end = Q4 ? (grp + 1) * g.GIN : 0;
  auto flush_g = [&](int gp) {
    const int gi = gp - g1_first;
    flush16(tg, lg, hg, sc + (0 * g.NG1 + gi) * TSM + jc1,
            sc + (1 * g.NG1 + gi) * TSM + jc1);
    if constexpr (!FFN)
      flush16(tu, lu, hu, sc + (2 * g.NG1 + gi) * TSM + jc1,
              sc + (3 * g.NG1 + gi) * TSM + jc1);
  };
  for (int r = r1; r < r1e; r += U1) {
    uint4 wg[U1], wu[U1];
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      wg[u] = ng[u];
      if constexpr (!FFN) wu[u] = nu[u];
    }
    load1(r + U1);
#pragma unroll
    for (int u = 0; u < U1; ++u) {
      if (r + u >= r1e) break;
      const float xl = xs[r + u - kb];
      if constexpr (Q4) {
        if (r + u == g_end) {          // the run crosses into the next group
          flush_g(grp++);
          g_end += g.GIN;
        }
        const float xh = xs[KC + r + u - kb];
        fma16<true>(lg, xl, wg[u], 0);
        fma16<true>(hg, xh, wg[u], 4);
        if constexpr (!FFN) {
          fma16<true>(lu, xl, wu[u], 0);
          fma16<true>(hu, xh, wu[u], 4);
        }
      } else {
        fma16<false>(tg, xl, wg[u], 0);
        if constexpr (!FFN) fma16<false>(tu, xl, wu[u], 0);
      }
    }
  }
  if (Q4 && r1 < r1e) flush_g(grp);
  // the row lanes' sums, added in lane order
  if (on1) {
#pragma unroll
    for (int q = 0; q < 16; q += 4) {
      *reinterpret_cast<float4*>(red + rl * TSM + jc1 + q) =
          make_float4(tg[q], tg[q + 1], tg[q + 2], tg[q + 3]);
      if constexpr (!FFN)
        *reinterpret_cast<float4*>(red + (g.RL1 + rl) * TSM + jc1 + q) =
            make_float4(tu[q], tu[q + 1], tu[q + 2], tu[q + 3]);
    }
  }
  __syncthreads();
  // ... and go to every rank of the cluster, as its row c of partials
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int j = tid; j < MATS * TSc; j += THREADS) {
    const bool up = j >= TSc;
    const float* col = red + (up ? g.RL1 * TSM + j - TSc : j);
    float v = 0.f;                    // lanes past the rows hold zeros
    for (int l = 0; l < g.RL1; ++l) v += col[l * TSM];
    const int at = (MATS * c + up) * TSM + j - (up ? TSc : 0);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < C) cluster.map_shared_rank(pf, r)[at] = v;
  }

  // ---- phase 2's first rows go out before the exchange ----
  const int rl2 = fdiv(tid, g.cl2), cl2 = tid - rl2 * g.CL2, jc2 = 16 * cl2;
  const bool on2 = rl2 < g.RL2 && jc2 < HCc;
  const int r2 = rl2 * g.run2, r2e = on2 ? min(r2 + g.run2, R) : r2;
  const uint8_t* pd = g.wd + (long long)p0 * g.H + hb + jc2;
  uint4 wd[U];                    // in flight while the ranks meet
#pragma unroll
  for (int u = 0; u < U; ++u)
    wd[u] = r2 + u < r2e ? ldg16(pd + (long long)(r2 + u) * g.H)
                         : make_uint4(0u, 0u, 0u, 0u);

  // ---- every rank's partials have arrived: added in rank order ----
  cluster.sync();
  for (int j = tid; j < TSc; j += THREADS) {
    float gs = 0.f, us = 0.f;
    for (int r = 0; r < C; ++r) {
      gs += pf[MATS * r * TSM + j];
      if constexpr (!FFN) us += pf[(2 * r + 1) * TSM + j];
    }
    float a;
    if (FFN) {
      a = act_fn(Q4 ? gs + b1s[j] : gs * sc[j] + b1s[j], g.act);
    } else {
      if (!Q4) {
        gs *= sc[j];
        us *= sc[TSM + j];
      }
      a = act_fn(gs, g.act) * us;
    }
    av[j] = __bfloat162float(__float2bfloat16(a));
  }
  __syncthreads();

  // ---- phase 2: lane (rl2, cl2) walks rows [r2, r2e) of the cluster ----
  float acc[16], lo2[16], hi2[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) acc[q] = lo2[q] = hi2[q] = 0.f;
  int grp2 = Q4 ? fdiv(p0 + r2, g.gmid) : 0;
  int g2_end = Q4 ? (grp2 + 1) * g.GMID - p0 : 0;   // in the cluster's rows
  auto flush_d = [&](int gp) {
    const int gi = gp - g2_first;
    flush16(acc, lo2, hi2, sc2 + gi * HCM + jc2, sc2 + (g.NG2 + gi) * HCM + jc2);
  };
  auto row2 = [&](int r, const uint4& w) {
    if constexpr (Q4) {
      if (r == g2_end) {
        flush_d(grp2++);
        g2_end += g.GMID;
      }
      fma16<true>(lo2, av[r], w, 0);
      fma16<true>(hi2, av[R + r], w, 4);
    } else {
      fma16<false>(acc, av[r], w, 0);
    }
  };
  for (int r = r2; r < r2e; r += U) {
    uint4 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = wd[u];
      const int rn = r + U + u;
      wd[u] = rn < r2e ? ldg16(pd + (long long)rn * g.H) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u < r2e) row2(r + u, cur[u]);
  }
  if (Q4 && r2 < r2e) flush_d(grp2);
  // the row lanes' sums (red is free: phase 1's sums were read into pf)
  if (on2) {
#pragma unroll
    for (int q = 0; q < 16; q += 4)
      *reinterpret_cast<float4*>(red + rl2 * HCM + jc2 + q) =
          make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
  }
  __syncthreads();
  for (int j = tid; j < HCc; j += THREADS) {
    float v = 0.f;
    for (int l = 0; l < g.RL2; ++l) v += red[l * HCM + j];
    if (g.S == 1) {
      if (!Q4) v *= sc2[j];
      if (FFN) v += b2s[j];
      g.out[hb + j] = v;
    } else {
      g.part[(long long)s * g.H + hb + j] = v;
    }
  }
  if (g.S > 1) {
    __shared__ int last;
    __syncthreads();
    int* counter = g.arrivals + c;
    // the block's partials (ordered before by the barrier) are released,
    // and the other blocks' acquired, by one acq_rel atomic
    if (tid == 0) last = arrive(counter) == g.S - 1;
    __syncthreads();
    if (last) {
      for (int jc = tid * 4; jc < HCc; jc += THREADS * 4) {
        const float* p = g.part + hb + jc;
        float4 tot = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s0 = 0; s0 < g.S; s0 += 8) {     // 8 slots in flight
          float4 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (s0 + q < g.S)
              v[q] = __ldcg(reinterpret_cast<const float4*>(p + (long long)(s0 + q) * g.H));
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (s0 + q < g.S) {
              tot.x += v[q].x; tot.y += v[q].y; tot.z += v[q].z; tot.w += v[q].w;
            }
        }
        if (!Q4) {
          tot.x *= sc2[jc]; tot.y *= sc2[jc + 1];
          tot.z *= sc2[jc + 2]; tot.w *= sc2[jc + 3];
        }
        if (FFN) {
          const float* b2 = b2s + jc;
          tot.x += b2[0]; tot.y += b2[1]; tot.z += b2[2]; tot.w += b2[3];
        }
        *reinterpret_cast<float4*>(g.out + hb + jc) = tot;
      }
      if (tid == 0) *counter = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// derive the launch geometry from the plan; false if the kernel cannot take
// it (ffn: the plain FFN, one first-projection matrix and the biases)
inline bool derive(Args& a, bool q4, bool ffn) {
  if (a.M <= 0 || a.H <= 0 || a.I <= 0 || a.C < 1 || a.C > MAX_CLUSTER ||
      (a.TS != 128 && a.TS != 256) || a.slots < 0 ||
      (a.slots > 0 && (a.M != 1 || a.H % 16)))
    return false;
  a.simt = a.slots > 0;
  a.K1 = q4 ? a.H / 2 : a.H;
  a.KC = ceil_div(ceil_div(a.K1, a.C), 16) * 16;
  a.HC = ceil_div(ceil_div(a.H, a.C), 128) * 128;
  if (!a.simt && a.HC != 128 && a.HC != 256 && a.HC != 512)
    return false;   // the tensor-core kernel is built for NC2 = 1, 2, 4
  a.Z = ceil_div(a.M, MT);
  a.vec = a.H % 16 == 0;
  if (q4) {
    const int R = a.TS / 2;
    if (a.BI <= 0 || a.BI % 32 || a.I % a.BI || a.GIN <= 0 || a.K1 % a.GIN ||
        a.SPT <= 0 || a.SPT % 2 || (a.BI / 2) % (a.SPT / 2))
      return false;
    a.GMID = (a.BI / 2) / (a.SPT / 2);
    a.U = ceil_div(a.BI / 2, R);
    a.S = (a.I / a.BI) * a.U;
    a.K2 = R;
    a.NG1 = ceil_div(a.KC, a.GIN) + 1;
    a.NG2 = ceil_div(R, a.GMID) + 1;
    a.n_g1 = a.K1 / a.GIN;
    a.gin = make_fastdiv(a.GIN);
    a.gmid = make_fastdiv(a.GMID);
    a.u = make_fastdiv(a.U);
  } else {
    a.S = ceil_div(a.I, a.TS);
    a.K2 = a.TS;
  }
  const size_t xk = q4 ? 2 * a.KC : a.KC, mats = ffn ? 1 : 2;
  const size_t wd_ring = STAGES * 16 * (size_t)(a.HC + PAD);
  const size_t stage = mats * 16 * (size_t)(a.TS + PAD);
  size_t ring = STAGES * stage;
  if (ring < mats * MT * (size_t)a.TS * 4) ring = mats * MT * (size_t)a.TS * 4;
  size_t base = MT * (xk * 2 + PAD) + MT * (2 * (size_t)a.TS + PAD) +
                wd_ring + ring;
  // the scales (int4: sized by the first projection's matrices) and the
  // FFN's biases
  const size_t biases = ffn ? a.TS + (size_t)a.HC : 0;
  size_t scales = q4 ? 4 * (mats * 2 * a.NG1 * (size_t)a.TS +
                            2 * (size_t)a.NG2 * a.HC + biases)
                     : 4 * (2 * (size_t)a.TS + (ffn ? 2 : 1) * (size_t)a.HC);
  a.sc_smem = !q4 || base + scales <= SMEM_MAX;
  a.smem = base + (a.sc_smem ? scales : 0);
  if (a.simt) {
    // the S clusters' chunks and the ranks' output chunks, balanced
    a.S = a.slots;
    a.n16 = q4 ? a.I / 32 : a.I / 16;           // int4: packed-row chunks
    a.h16 = a.H / 16;
    const int qmax = ceil_div(a.n16, a.S), hmax = ceil_div(a.h16, a.C);
    if (a.S > a.n16 || hmax * 16 > THREADS * 16) return false;
    a.TS = 16 * qmax * (q4 ? 2 : 1);
    a.HC = 16 * hmax;
    a.CL1 = a.TS / 16;
    a.RL1 = THREADS / a.CL1;
    a.CL2 = hmax;
    a.RL2 = THREADS / a.CL2;
    if (a.RL1 < 1 || a.RL2 < 1) return false;
    a.run1 = ceil_div(a.KC, a.RL1);
    a.run2 = ceil_div(16 * qmax, a.RL2);
    a.sdiv = make_fastdiv(a.S);
    a.cdiv = make_fastdiv(a.C);
    a.cl1 = make_fastdiv(a.CL1);
    a.cl2 = make_fastdiv(a.CL2);
    if (q4) {
      a.bi2 = make_fastdiv(a.BI / 2);
      a.spt2 = make_fastdiv(a.SPT / 2);
      a.NG2 = ceil_div(16 * qmax, a.GMID) + 1;
      a.n_g2 = (a.I / 2) / a.GMID;
    }
    // x, the row lanes' sums, every rank's partials and a, the scales
    const size_t red = mats * (size_t)a.RL1 * a.TS > (size_t)a.RL2 * a.HC
                           ? mats * (size_t)a.RL1 * a.TS : (size_t)a.RL2 * a.HC;
    const size_t sc = q4 ? mats * 2 * (size_t)a.NG1 * a.TS +
                               2 * (size_t)a.NG2 * a.HC +
                               (ffn ? a.TS + (size_t)a.HC : 0)
                         : 2 * (size_t)a.TS + (ffn ? 2 : 1) * (size_t)a.HC;
    a.sc_smem = 1;
    a.smem = 4 * (xk + red + (mats * a.C + 1) * (size_t)a.TS + sc);
  }
  return a.smem <= SMEM_MAX;
}

template <bool Q4, bool FFN, bool SIMT, int NC1, int NC2>
int launch(const Args& a, cudaStream_t st) {
  auto kern = SIMT ? gated_gemv_kernel<Q4, FFN>
                   : gated_mlp_kernel<Q4, FFN, NC1, NC2>;
  static size_t set_to[64] = {};   // the attribute, per device and size
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (a.smem > set_to[device]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)a.smem);
    if (e == cudaSuccess)   // all of the SM's 228 KB for shared memory
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    set_to[device] = a.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.C, (unsigned)a.Z, (unsigned)a.S);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool Q4, bool FFN>
int run(Args a, cudaStream_t st) {
  if (!derive(a, Q4, FFN) || (a.S > 1 && (!a.part || !a.arrivals)))
    return (int)cudaErrorInvalidValue;
  if (a.simt) return launch<Q4, FFN, true, 1, 1>(a, st);
  const int nc1 = a.TS / 128, nc2 = a.HC / 128;
#define TSK_GATED(N1, N2) \
  if (nc1 == N1 && nc2 == N2) return launch<Q4, FFN, false, N1, N2>(a, st);
  TSK_GATED(1, 1) TSK_GATED(1, 2) TSK_GATED(1, 4)
  TSK_GATED(2, 1) TSK_GATED(2, 2) TSK_GATED(2, 4)
#undef TSK_GATED
  return (int)cudaErrorInvalidValue;
}

// the plan's geometry, as the kernel takes it: out[0] = S (the slots of
// the workspace `part`), out[1] = the first row of Wd that slot S - 1 owns
// (int4: a packed row), out[2] = Z (the row tiles of x, each with its
// arrival counters)
template <bool Q4, bool FFN>
int geometry(Args a, int* out) {
  if (!derive(a, Q4, FFN)) return (int)cudaErrorInvalidValue;
  const int s = a.S - 1;
  if (a.simt)
    out[1] = 16 * (s * a.n16 / a.S);
  else if (Q4)
    out[1] = s / a.U * (a.BI / 2) + (s % a.U) * (a.TS / 2);
  else
    out[1] = s * a.TS;
  out[0] = a.S;
  out[2] = a.simt ? 1 : a.Z;
  return 0;
}

}  // namespace gated
