// Flash attention for Hopper: softmax(q k^T * scale) v on [B, T, H, D].
//
// Replaces ops/pallas/flash_attention.py `flash_attention` (kernels
// `_block_attn_kernel` and `_flash_kernel`), with its numerics: q.k^T in the
// input type with an f32 sum, times `scale`; keys at or past Tk, or past a
// per-batch true key length when `lengths` is given, and (causal) col > row
// masked to -1e30; an online softmax with max and sum in f32; P rounded to
// the input type as the operand of P.V, summed in f32; the output
// acc / max(l, 1e-30) in the input type.  One CTA owns a tile of query rows
// of one (batch, head) and streams 64-key tiles of K and V through shared
// memory, the next tile's copy (cp.async) in flight while the current one
// is used.  The ragged last key tile is zero-filled by the copy and masked.
//
// Bound on the H100: operations, 4 T^2 D B H of them.  At the training
// shape (bf16, B=8, T=1500, H=20, D=64) that is 92 GFLOP, 93 us on the
// tensor cores against 7.7 us for the 25.9 MB moved; at the served tower's
// (f32, B=1) 11.5 GFLOP, 172 us on the SIMT f32 units.
//
// bf16, flash_kernel_bf16 (tensor cores, mma.sync m16n8k16, f32 sums):
//   * 8 warps (4 at D = 128, for the registers) of 16 query rows each; the
//     warp keeps its Q fragments in registers, forms S = Q K^T from K tiles
//     read with ldmatrix, and feeds its S accumulators, exponentiated and
//     rounded to bf16, straight back as the A operand of P.V, with V read
//     by ldmatrix.trans: P never leaves the registers;
//   * rows padded by 16 bytes in shared memory, so ldmatrix hits 32 banks;
//   * only the ragged last tile and the causal diagonal's tiles are masked;
//     an exponent is one rounded multiply, a subtraction and the SFU's ex2;
//     the row max is a 4-lane shuffle; each lane keeps its part of the row
//     sum and the quad adds them once at the end.
// f32, flash_kernel_f32 (true f32 FMAs: no TF32, no tensor cores; the f32
// whisper tower's RVQ argmin over 512 codes flips on TF32-scale drift):
//   * 128 threads; thread (rg, cg) owns query rows 4 rg..4 rg+3 against keys
//     4 cg..4 cg+3 and 32+4 cg..32+4 cg+3 of S, and the same rows against
//     dims 4 cg + 32 i.. of the output: 32 FMAs for every three 16-byte
//     shared loads;
//   * Q and K are stored transposed ([d][row], [d][key]) and P as [key][row],
//     so every operand is a float4 along rows or keys; the chunks are XOR
//     swizzled, so neither the transposing 4-byte copies nor the float4
//     reads meet a bank conflict.
#include "attention_core.cuh"

using namespace tsk;

namespace {

constexpr int BK = 64;             // keys a tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Tq, Tk;
  float scale;
  int causal;
  const int* lengths;  // per-batch valid key count, or nullptr for Tk
};

// Number of key tiles a query tile [q0, q0 + BQ) visits: the keys up to the
// valid length (all Tk when it is 0, as the Pallas kernel sees them), and
// under the causal mask no tile past the tile's last row.  A skipped tile
// holds only masked keys, which add exactly 0 once a row has seen a valid
// key, and key 0 is valid for every row.
__device__ __forceinline__ int key_tiles(const Args& a, int kv_len, int q0,
                                         int BQ) {
  int n = ((kv_len > 0 ? kv_len : a.Tk) + BK - 1) / BK;
  if (a.causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Tile {
  static constexpr int WARPS = D == 128 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;   // query rows a CTA
  static constexpr int LDS = D + 8;       // shared row stride (elements)
  static constexpr int SMEM = (BQ + 4 * BK) * LDS * 2;
};

template <int D>
__global__ void __launch_bounds__(Bf16Tile<D>::THREADS)
    flash_kernel_bf16(Args a) {
  using Tile = Bf16Tile<D>;
  constexpr int BQ = Tile::BQ, LDS = Tile::LDS, NT = Tile::THREADS;
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NS = BK / 8;   // 8-key column tiles of S
  constexpr int NO = D / 8;    // 8-dim column tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LDS]
  bf16* Ks = Qs + BQ * LDS;                      // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                  // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ;
  const long long st = (long long)a.H * D;       // time stride
  const bf16* q = (const bf16*)a.q + (long long)b * a.Tq * st + h * D;
  const bf16* k = (const bf16*)a.k + (long long)b * a.Tk * st + h * D;
  const bf16* v = (const bf16*)a.v + (long long)b * a.Tk * st + h * D;
  bf16* o = (bf16*)a.o + (long long)b * a.Tq * st + h * D;
  int kv_len = a.Tk;
  if (a.lengths != nullptr) kv_len = min(max(a.lengths[b], 0), a.Tk);
  const int n_tiles = key_tiles(a, kv_len, q0, BQ);

  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = q0 + r;
    const bool in = row < a.Tq;
    cp_async<16>(Qs + r * LDS + c * 8, q + (in ? row : 0) * st + c * 8, in);
  }
  auto load_kv = [&](int t, int buf) {
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = i % CH, col = t * BK + r;
      const bool in = col < a.Tk;
      const long long off = (in ? col : 0) * st + c * 8;
      cp_async<16>(Ks + (buf * BK + r) * LDS + c * 8, k + off, in);
      cp_async<16>(Vs + (buf * BK + r) * LDS + c * 8, v + off, in);
    }
  };
  load_kv(0, 0);
  cp_commit();

  // lane (g, t4) holds rows g and g + 8 of the warp's 16, columns 2 t4, +1
  // of every 8-wide tile (the mma accumulator layout)
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float sl2 = a.scale * kLog2e;   // exp(s scale) = exp2(s sl2)
  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* Kb = Ks + buf * BK * LDS;
    const bf16* Vb = Vs + buf * BK * LDS;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];
        ldsm_x4(kf, Kb + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[j], qf[kk], kf[0], kf[1]);
        mma_bf16(s[j + 1], qf[kk], kf[2], kf[3]);
      }

    // the mask, on the tiles that need it (the ragged last one, the
    // causal diagonal), and the row max of the raw scores
    float mx0 = kNegInf, mx1 = kNegInf;
    const int k0 = t * BK;
    const bool edge = k0 + BK > kv_len || (a.causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (edge) {
          const int col = k0 + j * 8 + 2 * t4 + e;
          const bool ok = col < kv_len;
          if (!(ok && (!a.causal || col <= row0))) s[j][e] = kNegInf;
          if (!(ok && (!a.causal || col <= row1))) s[j][2 + e] = kNegInf;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // scale > 0, so max(s) * scale is the max of the scaled scores.  The
    // products are rounded apart from the subtraction (no FMA), so a row
    // whose keys are all masked gets exp2(0) = 1 for each, as on the TPU
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = fast_exp2((m0 - mn0) * sl2);
    const float al1 = fast_exp2((m1 - mn1) * sl2);
    const float ms0 = __fmul_rn(mn0, sl2), ms1 = __fmul_rn(mn1, sl2);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // P = exp(s - m) in f32 for the sums, rounded to bf16 as the A operand
    // of P.V: two 8-key accumulator tiles make one 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* sj = s[2 * kk + half];
        const float p0 = fast_exp2(__fmul_rn(sj[0], sl2) - ms0);
        const float p1 = fast_exp2(__fmul_rn(sj[1], sl2) - ms0);
        const float p2 = fast_exp2(__fmul_rn(sj[2], sl2) - ms1);
        const float p3 = fast_exp2(__fmul_rn(sj[3], sl2) - ms1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        pa[2 * half] = pack_bf16(p0, p1);
        pa[2 * half + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   LDS + (j + (lane >> 4)) * 8);
        mma_bf16(acc[j], pa, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // the buffer is refilled in the next iteration
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = j * 8 + 2 * t4;
    if (row0 < a.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + row0 * st + col) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < a.Tq)
      *reinterpret_cast<__nv_bfloat162*>(o + row1 * st + col) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// f32 on the SIMT units
// ---------------------------------------------------------------------------

constexpr int F32_BQ = 64, F32_THREADS = 128;

template <int D>
constexpr int f32_smem_bytes() {
  return (F32_BQ * D + 2 * BK * D + 2 * BK * D + BK * F32_BQ) * 4;
}

// float4 chunk (of 16 in a 64-wide row) where chunk c of row r is stored
__device__ __forceinline__ int swz(int c, int r) { return c ^ (r & 7); }

template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_kernel_f32(Args a) {
  constexpr int BQ = F32_BQ, NT = F32_THREADS, NI = D / 32;
  extern __shared__ __align__(16) float smf[];
  float* Qt = smf;               // [D][BQ], chunks swizzled by d
  float* Kt = Qt + D * BQ;       // [2][D][BK], chunks swizzled by d
  float* Vs = Kt + 2 * D * BK;   // [2][BK][D]
  float* Pt = Vs + 2 * BK * D;   // [BK][BQ], chunks swizzled by key / 4
  const float4* Qt4 = reinterpret_cast<const float4*>(Qt);
  const float4* Pt4 = reinterpret_cast<const float4*>(Pt);

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int q0 = blockIdx.x * BQ;
  const long long st = (long long)a.H * D;
  const float* q = (const float*)a.q + (long long)b * a.Tq * st + h * D;
  const float* k = (const float*)a.k + (long long)b * a.Tk * st + h * D;
  const float* v = (const float*)a.v + (long long)b * a.Tk * st + h * D;
  float* o = (float*)a.o + (long long)b * a.Tq * st + h * D;
  int kv_len = a.Tk;
  if (a.lengths != nullptr) kv_len = min(max(a.lengths[b], 0), a.Tk);
  const int n_tiles = key_tiles(a, kv_len, q0, BQ);

  // a 64-row tile of x [row][d] into xt [d][row] by 4-byte copies: lane
  // (ks, dl) of each group of 32 takes row 4 kq + ks, dim 8 dq + dl, so a
  // warp reads four 32-byte runs and writes 32 distinct banks
  auto load_t = [&](float* xt, const float* x, int r0, int n_rows) {
    for (int i = tid; i < 64 * D; i += NT) {
      const int dl = i & 7, ks = (i >> 3) & 3, rest = i >> 5;
      const int d = (rest % (D / 8)) * 8 + dl, r = (rest / (D / 8)) * 4 + ks;
      const bool in = r0 + r < n_rows;
      cp_async<4>(xt + d * 64 + swz(r >> 2, d) * 4 + (r & 3),
                  x + (in ? r0 + r : 0) * st + d, in);
    }
  };
  auto load_kv = [&](int t, int buf) {
    load_t(Kt + buf * D * BK, k, t * BK, a.Tk);
    float* vb = Vs + buf * BK * D;
    for (int i = tid; i < BK * D / 4; i += NT) {
      const int r = i / (D / 4), c = i % (D / 4), col = t * BK + r;
      const bool in = col < a.Tk;
      cp_async<16>(vb + r * D + c * 4, v + (in ? col : 0) * st + c * 4, in);
    }
  };
  load_t(Qt, q, q0, a.Tq);
  load_kv(0, 0);
  cp_commit();

  float acc[4][NI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NI; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float4* Kt4 = reinterpret_cast<const float4*>(Kt + buf * D * BK);
    const float4* Vb4 = reinterpret_cast<const float4*>(Vs + buf * BK * D);

    // s[i][j]: row 4 rg + i against key 4 cg + j (j < 4), 32 + 4 cg + j - 4
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = Qt4[d * 16 + swz(rg, d)];
      const float4 ka = Kt4[d * 16 + swz(cg, d)];
      const float4 kb = Kt4[d * 16 + swz(8 + cg, d)];
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rg + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = t * BK + (j < 4 ? 4 * cg + j : 28 + 4 * cg + j);
        const bool ok = col < kv_len && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx), alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NI; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    // P^T: key kk, rows 4 rg.. as one float4 in chunk swz(rg, kk / 4)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = j < 4 ? 4 * cg + j : 28 + 4 * cg + j;
      reinterpret_cast<float4*>(Pt)[key * 16 + swz(rg, key >> 2)] =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pa = Pt4[kk * 16 + swz(rg, kk >> 2)];
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < NI; ++c) {
        const float4 vb = Vb4[kk * (D / 4) + 8 * c + cg];
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c][e] = fmaf(pv[i], vv[e], acc[i][c][e]);
      }
    }
    __syncthreads();   // P and the buffer are rewritten in the next iteration
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= a.Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NI; ++c)
      *reinterpret_cast<float4*>(o + row * st + 32 * c + 4 * cg) =
          make_float4(acc[i][c][0] * inv, acc[i][c][1] * inv,
                      acc[i][c][2] * inv, acc[i][c][3] * inv);
  }
}

template <int D>
int launch(const Args& a, int B, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    using Tile = Bf16Tile<D>;
    cudaFuncSetAttribute(flash_kernel_bf16<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Tile::SMEM);
    dim3 grid((a.Tq + Tile::BQ - 1) / Tile::BQ, B * a.H);
    flash_kernel_bf16<D><<<grid, Tile::THREADS, Tile::SMEM, stream>>>(a);
  } else {
    constexpr int smem = f32_smem_bytes<D>();
    cudaFuncSetAttribute(flash_kernel_f32<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid((a.Tq + F32_BQ - 1) / F32_BQ, B * a.H);
    flash_kernel_f32<D><<<grid, F32_THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D], o [B, Tq, H, D], all contiguous.
// dtype 0 = float32, 1 = bfloat16.  lengths: int32 [B] true key lengths on
// the device, or null for Tk.  Returns cudaGetLastError().
extern "C" int tsk_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Tq, int Tk, int H, int D, float scale,
                                   int causal, const void* lengths,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, H, Tq, Tk, scale, causal, (const int*)lengths};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(a, B, dtype, s);
    case 64: return launch<64>(a, B, dtype, s);
    case 128: return launch<128>(a, B, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
