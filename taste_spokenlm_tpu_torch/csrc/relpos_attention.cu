// Causal espnet rel-pos attention for Hopper, forward and backward:
//
//   s[i, j] = (q_u[i] . k[j] + q_v[i] . p[(T-1) - i + j]) / sqrt(dk)
//   o = softmax(s masked to j <= i and j < len_b) @ v
//
// Replaces ops/pallas/relpos_attention.py `relpos_causal_attention`
// (`_fwd_kernel`, `_bwd_kernel` and their custom VJP).  The TPU kernel
// builds the bd term as a q_v @ p_window matmul plus a log2(BQ) masked-shift
// skew, because a TPU cannot gather; here the table is indexed directly.  A
// 64 x 64 tile of queries q0.. and keys k0.. reads the 127 table rows
// (T-1) - q0 - 63 + k0 + w, w = 63 - i + j in [0, 126], staged in shared
// memory; under the causal mask only rows 0..T-1 of p are ever read, so the
// gradient's rows T..2T-2 are exactly zero.
//
// Layout: q_u, q_v, k, v, o, dO, dq_u, dq_v, dk, dv [B, T, H, 128]; p, dp
// [2T-1, H, 128]; lse, delta f32 [B*H, T]; lengths int32 [B] (clamped to
// [0, T] by the wrapper); dp_part and pg scratch (tsk_relpos_bwd).
//
// Bound on the H100: operations (~3 T^2 dk B H forward and ~8 T^2 dk B H
// backward over the causal half) at the stage-1 shape B=8, T=1599, H=8.
//
// The float32 route: SIMT kernels, one CTA of 256 threads per 64 x 64 tile,
// 1 CTA per SM for the shared memory, every product a true f32 FMA (no
// TF32, no tensor cores), operands widened to f32 on their way into shared
// memory; causal pruning: a query tile visits key tiles k0 <= q0 only.
//   fwd:      (B*H, query tile): online softmax, o in the operand dtype and
//             lse = m + log(max(l, 1e-30)) in f32, acc / max(l, 1e-30) as
//             the TPU kernel (a row with no valid key gives 0);
//   bwd f32:  five launches and no float atomics, so the gradients repeat
//             bit for bit: delta = rowsum(dO . o) per row; dq_u, dq_v per
//             (B*H, query tile); dk, dv per (B*H, key tile); dp per (B*H,
//             tile of 64 diagonals delta = i - j) into dp_part[b]; then dp =
//             sum over b in order.  Each recomputes prob = exp(s - lse) and
//             g = prob (dO . v - delta) / sqrt(dk) and rounds prob and g to
//             the operand dtype before its products (the TPU kernel's cast
//             points, relpos_attention.py:197-221).
// The bfloat16 route runs its products on the tensor cores, the forward
// (fwd_kernel_mma) and the backward: see "bf16 on the tensor cores" below.
#include "attention_core.cuh"

using namespace tsk;

namespace {

constexpr int D = 128;           // head dim
constexpr int BT = 64;           // tile rows: queries, keys or diagonals
constexpr int LD = D + 1;        // shared row stride in floats
constexpr int LG = BT + 1;       // stride of the 64 x 64 prob / g tiles
constexpr int NT = 256;          // threads: a 16 x 16 grid (ty, tx)
constexpr float kScale = 0.08838834764831845f;  // 1 / sqrt(128)
constexpr int kTileFloats = BT * LD;

// Thread (ty, tx) owns rows row(a), a < 4, and columns tx + 16 c, c < 4,
// of a 64 x 64 tile.  The two half-warps of a warp (ty even / odd) hold rows
// 16 apart, so the skewed table reads of one warp hit 32 distinct banks;
// row reductions are shuffles inside a half-warp.
__device__ __forceinline__ int row_base(int ty) {
  return 16 * (ty & 1) + 2 * (ty >> 1);
}
__device__ __forceinline__ int row_of(int base, int a) {
  return base + (a & 1) + 32 * (a >> 1);
}

struct Args {
  const void *qu, *qv, *k, *v, *p;
  const int* len;
  const void* o;
  const float* lse;
  const void* dO;
  void* o_out;
  float* lse_out;
  void *dqu, *dqv, *dk, *dv, *dp;
  float* delta;
  float* dp_part;
  bf16* pg;          // bf16 route: prob and g of every tile pair
  int B, T, H;
};

// rows r0 .. r0+n-1 of a [rows, D] operand with row stride `stride` into
// shared f32 [n][LD]; rows outside [lo, hi) read as 0
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long stride, int r0, int n,
                                          int lo, int hi) {
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, d = idx % D, g = r0 + r;
    dst[r * LD + d] = (g >= lo && g < hi) ? to_f32(src[g * stride + d]) : 0.f;
  }
}

__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Scores of a query tile against a key tile, unscaled and unmasked:
// s[a][c] = Qu[row(a)] . K[col(c)] + Qv[row(a)] . Pw[63 - row(a) + col(c)].
// The 16 table rows a thread reads are 12 distinct ones:
// w = (31 - base + tx) + 16 m - e with m = c - 2 (a >> 1) + 2, e = a & 1.
__device__ __forceinline__ void scores_qk(const float* Qu, const float* Qv,
                                          const float* K, const float* Pw,
                                          int base, int tx, float (&s)[4][4]) {
  float ac[4][4], bd[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) ac[a][c] = bd[a][c] = 0.f;
  const int w0 = 31 - base + tx;
  for (int d = 0; d < D; ++d) {
    float qu[4], qv[4], kk[4], pw[6][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qu[a] = Qu[row_of(base, a) * LD + d];
      qv[a] = Qv[row_of(base, a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) kk[c] = K[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int m = 0; m < 6; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) pw[m][e] = Pw[(w0 + 16 * m - e) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ac[a][c] = fmaf(qu[a], kk[c], ac[a][c]);
        bd[a][c] = fmaf(qv[a], pw[c - 2 * (a >> 1) + 2][a & 1], bd[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = ac[a][c] + bd[a][c];
}

// Scores of a query tile against a tile of 64 diagonals delta = i - j:
// s[a][c] = Qu[row(a)] . Kw[row(a) - col(c) + 63] + Qv[row(a)] . Pd[col(c)],
// Kw the 127 key rows i0 - d0 - 63 + w.  Key rows read: 12 distinct,
// w = (15 + base - tx) + 16 m + e with m = 2 (a >> 1) - c + 3, e = a & 1.
// With Qv = nullptr it is the plain skewed product dO . Vw (no bd term).
__device__ __forceinline__ void scores_diag(const float* Qu, const float* Qv,
                                            const float* Kw, const float* Pd,
                                            int base, int tx,
                                            float (&s)[4][4]) {
  float ac[4][4], bd[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) ac[a][c] = bd[a][c] = 0.f;
  const int w0 = 15 + base - tx;
  for (int d = 0; d < D; ++d) {
    float qu[4], kw[6][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) qu[a] = Qu[row_of(base, a) * LD + d];
#pragma unroll
    for (int m = 0; m < 6; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) kw[m][e] = Kw[(w0 + 16 * m + e) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ac[a][c] = fmaf(qu[a], kw[2 * (a >> 1) - c + 3][a & 1], ac[a][c]);
    if (Qv != nullptr) {
      float qv[4], pd[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qv[row_of(base, a) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) pd[c] = Pd[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) bd[a][c] = fmaf(qv[a], pd[c], bd[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = ac[a][c] + bd[a][c];
}

// out[a][c] = A[row(a)] . B[col(c)] (dO . v^T of a query and a key tile)
__device__ __forceinline__ void dot_qk(const float* A, const float* Bm,
                                       int base, int tx, float (&out)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[a][c] = 0.f;
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[row_of(base, a) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) out[a][c] = fmaf(x[a], y[c], out[a][c]);
  }
}

// ---------------------------------------------------------------------------
// forward: one CTA per (b*h, query tile)
// ---------------------------------------------------------------------------

constexpr int kFwdSmem = (2 * BT + BT + 2 * BT) * LD * 4 + BT * LG * 4;

template <typename T>
__global__ void __launch_bounds__(NT, 1) fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qu = smem;                  // [64][LD]
  float* Qv = Qu + kTileFloats;      // [64][LD]
  float* K = Qv + kTileFloats;       // [64][LD]
  float* Pw = K + kTileFloats;       // [128][LD]; the V tile after scores
  float* Ps = Pw + 2 * kTileFloats;  // [64][LG]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int base = row_base(ty);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, q0 = blockIdx.x * BT;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const T* qu = (const T*)a.qu + off;
  const T* qv = (const T*)a.qv + off;
  const T* k = (const T*)a.k + off;
  const T* v = (const T*)a.v + off;
  const T* p = (const T*)a.p + (long long)h * D;
  const int len = a.len[b];

  load_rows(Qu, qu, rs, q0, BT, 0, T_);
  load_rows(Qv, qv, rs, q0, BT, 0, T_);
  const int n_k = min(min(q0 + BT, T_) - 1, len - 1) / BT + 1;  // 0 if len 0

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int kt = 0; kt < (len > 0 ? n_k : 0); ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_rows(K, k, rs, k0, BT, 0, T_);
    load_rows(Pw, p, rs, (T_ - 1) - q0 - 63 + k0, 2 * BT, 0, T_);
    __syncthreads();
    float s[4][4];
    scores_qk(Qu, Qv, K, Pw, base, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + row_of(base, i);
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        ok[c] = col <= row && col < len;
        s[i][c] = ok[c] ? s[i][c] * kScale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += e;
        Ps[row_of(base, i) * LG + tx + 16 * c] = round_to<T>(e);
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    load_rows(Pw, v, rs, k0, BT, 0, T_);  // V over the table window
    __syncthreads();
    for (int kk = 0; kk < BT; ++kk) {
      float pa[4], vb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[row_of(base, i) * LG + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) vb[j] = Pw[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  T* o = (T*)a.o_out + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + row_of(base, i);
    if (row >= T_) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[row * rs + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0) a.lse_out[(long long)bh * T_ + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// backward 1: delta = rowsum(dO . o) in f32, one warp per (b*h, row)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) delta_kernel(Args a) {
  const int warp = (blockIdx.x * NT + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (warp >= a.B * a.H * a.T) return;
  const int bh = warp / a.T, row = warp % a.T, b = bh / a.H, h = bh % a.H;
  const long long at = (((long long)b * a.T + row) * a.H + h) * D;
  const T* o = (const T*)a.o + at;
  const T* dO = (const T*)a.dO + at;
  float x = 0.f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
    x = fmaf(to_f32(dO[lane + 32 * i]), to_f32(o[lane + 32 * i]), x);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (lane == 0) a.delta[(long long)bh * a.T + row] = x;
}

// prob and g of the thread's 4 x 4 entries of a (query, key) tile from the
// raw scores s and dO . v (dpv); masked entries give 0
__device__ __forceinline__ void prob_and_g(float (&s)[4][4], float (&dpv)[4][4],
                                           const bool (&ok)[4][4],
                                           const float* lse, const float* dl,
                                           int base, float (&prob)[4][4],
                                           float (&g)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row_of(base, i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      prob[i][c] = ok[i][c] ? expf(s[i][c] * kScale - lse[r]) : 0.f;
      g[i][c] = prob[i][c] * (dpv[i][c] - dl[r]) * kScale;
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: dq_u, dq_v per (b*h, query tile)
// ---------------------------------------------------------------------------

constexpr int kDqSmem = (2 * BT + BT + BT + 2 * BT) * LD * 4 + BT * LG * 4
                        + 2 * BT * 4;

template <typename T>
__global__ void __launch_bounds__(NT, 1) dq_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qv = smem;                  // [64][LD]
  float* dO = Qv + kTileFloats;      // [64][LD]
  float* QuV = dO + kTileFloats;     // [64][LD]: Qu for the scores, then V
  float* K = QuV + kTileFloats;      // [64][LD]
  float* Pw = K + kTileFloats;       // [128][LD]
  float* G = Pw + 2 * kTileFloats;   // [64][LG]
  float* lse = G + BT * LG;          // [64]
  float* dl = lse + BT;              // [64]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int base = row_base(ty);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, q0 = blockIdx.x * BT;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const T* qu = (const T*)a.qu + off;
  const T* k = (const T*)a.k + off;
  const T* v = (const T*)a.v + off;
  const T* p = (const T*)a.p + (long long)h * D;
  const int len = a.len[b];

  load_rows(Qv, (const T*)a.qv + off, rs, q0, BT, 0, T_);
  load_rows(dO, (const T*)a.dO + off, rs, q0, BT, 0, T_);
  if (tid < BT) {
    const bool in = q0 + tid < T_;
    lse[tid] = in ? a.lse[(long long)bh * T_ + q0 + tid] : 0.f;
    dl[tid] = in ? a.delta[(long long)bh * T_ + q0 + tid] : 0.f;
  }
  const int n_k = len > 0 ? min(min(q0 + BT, T_) - 1, len - 1) / BT + 1 : 0;

  float dqu[4][8], dqv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dqu[i][j] = dqv[i][j] = 0.f;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_rows(QuV, qu, rs, q0, BT, 0, T_);
    load_rows(K, k, rs, k0, BT, 0, T_);
    load_rows(Pw, p, rs, (T_ - 1) - q0 - 63 + k0, 2 * BT, 0, T_);
    __syncthreads();
    float s[4][4], dpv[4][4], prob[4][4], g[4][4];
    bool ok[4][4];
    scores_qk(QuV, Qv, K, Pw, base, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + row_of(base, i), col = k0 + tx + 16 * c;
        ok[i][c] = col <= row && col < len && row < T_;
      }
    __syncthreads();
    load_rows(QuV, v, rs, k0, BT, 0, T_);
    __syncthreads();
    dot_qk(dO, QuV, base, tx, dpv);
    prob_and_g(s, dpv, ok, lse, dl, base, prob, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        G[row_of(base, i) * LG + tx + 16 * c] = round_to<T>(g[i][c]);
    __syncthreads();
    // dq_u[i] += sum_j g[i][j] k[j]; dq_v[i] += sum_j g[i][j] Pw[63 - i + j].
    // Row 63 - (r + 1) + j + 1 = 63 - r + j: the table row an odd row(a)
    // reads at j is the one its even neighbour read at j - 1 (carried).
    float prev[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        prev[u][j] = Pw[(62 - base - 32 * u) * LD + tx + 16 * j];
    for (int jj = 0; jj < BT; ++jj) {
      float gr[4], kr[8], cur[2][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gr[i] = G[row_of(base, i) * LG + jj];
#pragma unroll
      for (int j = 0; j < 8; ++j) kr[j] = K[jj * LD + tx + 16 * j];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cur[u][j] = Pw[(63 - base - 32 * u + jj) * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dqu[i][j] = fmaf(gr[i], kr[j], dqu[i][j]);
          const float pr = (i & 1) ? prev[i >> 1][j] : cur[i >> 1][j];
          dqv[i][j] = fmaf(gr[i], pr, dqv[i][j]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) prev[u][j] = cur[u][j];
    }
  }
  T* oqu = (T*)a.dqu + off;
  T* oqv = (T*)a.dqv + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + row_of(base, i);
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oqu[row * rs + tx + 16 * j] = from_f32<T>(dqu[i][j]);
      oqv[row * rs + tx + 16 * j] = from_f32<T>(dqv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dk, dv per (b*h, key tile)
// ---------------------------------------------------------------------------

constexpr int kDkvSmem = (3 * BT + 3 * BT) * LD * 4 + 2 * BT * 4;

template <typename T>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(Args a) {
  extern __shared__ float smem[];
  float* K = smem;                   // [64][LD]
  float* V = K + kTileFloats;        // [64][LD]
  float* Qu = V + kTileFloats;       // [64][LD]
  float* R = Qu + kTileFloats;       // [192][LD]: Qv + Pw, then dO + P + G
  float* lse = R + 3 * kTileFloats;  // [64]
  float* dl = lse + BT;              // [64]
  float* Qv = R;
  float* Pw = R + kTileFloats;
  float* dO = R;
  float* P = R + kTileFloats;        // [64][LG]
  float* G = P + BT * LG;            // [64][LG]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int base = row_base(ty);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, k0 = blockIdx.x * BT, nq = (T_ + BT - 1) / BT;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const T* qu = (const T*)a.qu + off;
  const T* qv = (const T*)a.qv + off;
  const T* dOg = (const T*)a.dO + off;
  const T* p = (const T*)a.p + (long long)h * D;
  const int len = a.len[b];

  load_rows(K, (const T*)a.k + off, rs, k0, BT, 0, T_);
  load_rows(V, (const T*)a.v + off, rs, k0, BT, 0, T_);
  float dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int qt = (k0 < len ? blockIdx.x : nq); qt < nq; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_rows(Qu, qu, rs, q0, BT, 0, T_);
    load_rows(Qv, qv, rs, q0, BT, 0, T_);
    load_rows(Pw, p, rs, (T_ - 1) - q0 - 63 + k0, 2 * BT, 0, T_);
    if (tid < BT) {
      const bool in = q0 + tid < T_;
      lse[tid] = in ? a.lse[(long long)bh * T_ + q0 + tid] : 0.f;
      dl[tid] = in ? a.delta[(long long)bh * T_ + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpv[4][4], prob[4][4], g[4][4];
    bool ok[4][4];
    scores_qk(Qu, Qv, K, Pw, base, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + row_of(base, i), col = k0 + tx + 16 * c;
        ok[i][c] = col <= row && col < len && row < T_;
      }
    __syncthreads();
    load_rows(dO, dOg, rs, q0, BT, 0, T_);
    __syncthreads();
    dot_qk(dO, V, base, tx, dpv);
    prob_and_g(s, dpv, ok, lse, dl, base, prob, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        P[row_of(base, i) * LG + tx + 16 * c] = round_to<T>(prob[i][c]);
        G[row_of(base, i) * LG + tx + 16 * c] = round_to<T>(g[i][c]);
      }
    __syncthreads();
    // dv[j] += sum_i prob[i][j] dO[i]; dk[j] += sum_i g[i][j] q_u[i]
    for (int ii = 0; ii < BT; ++ii) {
      float pr[4], gr[4], dor[8], qr[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = P[ii * LG + row_of(base, i)];
        gr[i] = G[ii * LG + row_of(base, i)];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dor[j] = dO[ii * LD + tx + 16 * j];
        qr[j] = Qu[ii * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          dv[i][j] = fmaf(pr[i], dor[j], dv[i][j]);
          dk[i][j] = fmaf(gr[i], qr[j], dk[i][j]);
        }
    }
  }
  T* odk = (T*)a.dk + off;
  T* odv = (T*)a.dv + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + row_of(base, i);
    if (row >= T_) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      odk[row * rs + tx + 16 * j] = from_f32<T>(dk[i][j]);
      odv[row * rs + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 4: dp_part[b][T-1-delta] = sum_i g[i][i - delta] q_v[i] per
// (b*h, tile of 64 diagonals), then 5: dp = sum over b in order
// ---------------------------------------------------------------------------

constexpr int kDpSmem = (BT + 3 * BT + 2 * BT) * LD * 4 + BT * LG * 4
                        + 2 * BT * 4;

template <typename T>
__global__ void __launch_bounds__(NT, 1) dp_kernel(Args a) {
  extern __shared__ float smem[];
  float* Pd = smem;                  // [64][LD]: p[T-1-delta]
  float* Qu = Pd + kTileFloats;      // [64][LD]
  float* Qv = Qu + kTileFloats;      // [64][LD]
  float* dO = Qv + kTileFloats;      // [64][LD]
  float* W = dO + kTileFloats;       // [128][LD]: key rows, then value rows
  float* G = W + 2 * kTileFloats;    // [64][LG]: g[i][delta]
  float* lse = G + BT * LG;          // [64]
  float* dl = lse + BT;              // [64]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int base = row_base(ty);
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, d0 = blockIdx.x * BT, nq = (T_ + BT - 1) / BT;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const T* qu = (const T*)a.qu + off;
  const T* qv = (const T*)a.qv + off;
  const T* k = (const T*)a.k + off;
  const T* v = (const T*)a.v + off;
  const T* dOg = (const T*)a.dO + off;
  const int len = a.len[b];

  // Pd[dd] = p[T-1-d0-dd]: rows loaded in reverse order
  for (int idx = tid; idx < BT * D; idx += NT) {
    const int r = idx / D, d = idx % D, g = T_ - 1 - d0 - r;
    Pd[r * LD + d] = g >= 0 ? to_f32(((const T*)a.p)[g * rs + h * D + d]) : 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // query tiles with a valid key i - delta in [0, len) for some delta of
  // the tile: i0 >= d0 and i0 - d0 - 63 < len
  const int it_end = min(nq, (len + d0 + 62) / BT + 1);
  for (int it = blockIdx.x; it < it_end; ++it) {
    const int i0 = it * BT, w_lo = i0 - d0 - 63;
    __syncthreads();
    load_rows(Qu, qu, rs, i0, BT, 0, T_);
    load_rows(Qv, qv, rs, i0, BT, 0, T_);
    load_rows(dO, dOg, rs, i0, BT, 0, T_);
    load_rows(W, k, rs, w_lo, 2 * BT, 0, T_);
    if (tid < BT) {
      const bool in = i0 + tid < T_;
      lse[tid] = in ? a.lse[(long long)bh * T_ + i0 + tid] : 0.f;
      dl[tid] = in ? a.delta[(long long)bh * T_ + i0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpv[4][4], prob[4][4], g[4][4];
    bool ok[4][4];
    scores_diag(Qu, Qv, W, Pd, base, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = i0 + row_of(base, i);
        const int col = row - (d0 + tx + 16 * c);
        ok[i][c] = col >= 0 && col < len && row < T_;
      }
    __syncthreads();
    load_rows(W, v, rs, w_lo, 2 * BT, 0, T_);
    __syncthreads();
    scores_diag(dO, nullptr, W, nullptr, base, tx, dpv);
    prob_and_g(s, dpv, ok, lse, dl, base, prob, g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        G[row_of(base, i) * LG + tx + 16 * c] = round_to<T>(g[i][c]);
    __syncthreads();
    // acc[delta][d] += sum_i g[i][delta] q_v[i][d]
    for (int ii = 0; ii < BT; ++ii) {
      float gr[4], qr[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) gr[i] = G[ii * LG + row_of(base, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) qr[j] = Qv[ii * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gr[i], qr[j], acc[i][j]);
    }
  }
  float* part = a.dp_part + (long long)b * T_ * rs + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = T_ - 1 - (d0 + row_of(base, i));
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) part[r * rs + tx + 16 * j] = acc[i][j];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) dp_reduce_kernel(Args a) {
  const long long rs = (long long)a.H * D;
  const long long n = (2LL * a.T - 1) * rs;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= n) return;
  const long long r = idx / rs;
  float x = 0.f;
  if (r < a.T)
    for (int b = 0; b < a.B; ++b) x += a.dp_part[(long long)b * a.T * rs + idx];
  ((T*)a.dp)[idx] = from_f32<T>(x);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (mma.sync m16n8k16, f32 sums), forward and
// backward
//
// Four warps, each owning 16 rows of a 64 x 64 (query, key) tile.  For a
// tile pair the table window is Pw[w] = p[(T-1) - q0 - 63 + k0 + w], w < 128,
// and score (r, c) takes Pw[63 - r + c].  Warp wi's rows reach the 80 window
// rows wb = 48 - 16 wi .. wb + 79, so it forms X = Qv . Pw[wb..wb+79]^T
// (16 x 80, f32) on the tensor cores and reads the bd term of row rl, key c
// as X[rl][15 - rl + c] from its own shared scratch: the TPU kernel's
// _skew_left as one offset read.  The same offset in the other direction
// is its _skew_right: gw[rl][15 - rl + c] = g[rl][c] (bf16, zero elsewhere)
// and dq_v += gw . Pw[wb..wb+79].  score_tile forms the scores for both
// directions.
//
//   fwd_kernel_mma  (query tile, b*h): the scores of every key tile j <= i,
//                   an online softmax in registers, o += bf16(e) . V;
//   dq_kernel_mma   (query tile, b*h): scores, prob and g of every key tile
//                   j <= i (K, V and the window through a two-stage cp.async
//                   ring); dq_u += g . K (g from registers as the A operand),
//                   dq_v += gw . Pw; prob and g, rounded to bf16, are stored
//                   per tile pair for the next two launches;
//   dkv_kernel_mma  (key tile, b*h): dv += prob^T . dO, dk += g^T . q_u over
//                   the stored tiles of the query tiles i >= j;
//   dp_kernel_mma   (tile diagonal dd = (q0 - k0) / 64, b*h): every pair of
//                   the diagonal reads the same window, so dPw += gW^T . q_v
//                   (128 x 128) with gW[r][63 - r + c] = g[r][c] summed over
//                   the diagonal into dp_part[b][dd];
//   dp_sum_kernel:  dp[(T-1) - delta] = sum over b, then over the two
//                   diagonals whose windows hold delta, in that order.
// Every sum has a fixed order: no atomics, the gradients repeat bit for bit.
// ---------------------------------------------------------------------------

constexpr int NW = 4;                 // warps of the mma kernels
constexpr int NTB = 32 * NW;          // their threads
constexpr int LDB = D + 8;            // bf16 stride of a 128-wide row (272 B)
constexpr int LDT = BT + 8;           // bf16 stride of a 64-wide row (144 B)
constexpr int LDX = 88;               // f32 stride of X, bf16 stride of gw
constexpr int kTileB = BT * LDB;      // elements of a staged 64-row operand
constexpr int kPair = BT * BT;        // elements of a stored prob or g tile
constexpr int kXs = 16 * LDX;         // floats of a warp's scratch

__host__ __device__ __forceinline__ int n_pairs(int nq) {
  return nq * (nq + 1) / 2;
}
__device__ __forceinline__ int pair_of(int qt, int kt) {
  return qt * (qt + 1) / 2 + kt;
}

// rows r0 .. r0+n-1 of a [rows, 128] bf16 operand with row stride `rs`
// into shared [n][LDB]; rows outside [0, hi) are zero-filled; thread t of
// the nt threads that share the copy
__device__ __forceinline__ void cp_rows_by(bf16* dst, const bf16* src,
                                           long long rs, int r0, int n,
                                           int hi, int t, int nt) {
  for (int i = t; i < n * (D / 8); i += nt) {
    const int r = i / (D / 8), c = i % (D / 8), g = r0 + r;
    const bool in = g >= 0 && g < hi;
    cp_async<16>(dst + r * LDB + c * 8, src + (in ? g * rs : 0) + c * 8, in);
  }
}
// ... by the CTA's NTB threads
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src,
                                        long long rs, int r0, int n, int hi) {
  cp_rows_by(dst, src, rs, r0, n, hi, threadIdx.x, NTB);
}

// a stored 64 x 64 bf16 tile into shared [64][LDT]
__device__ __forceinline__ void cp_pair(bf16* dst, const bf16* src) {
  for (int i = threadIdx.x; i < BT * (BT / 8); i += NTB) {
    const int r = i / (BT / 8), c = i % (BT / 8);
    cp_async<16>(dst + r * LDT + c * 8, src + r * BT + c * 8, true);
  }
}

// the shared operands of one (query tile, key tile) pair
struct PairTiles {
  const bf16 *qu, *qv, *dO;   // [64][LDB], query rows q0..
  const bf16 *k, *v;          // [64][LDB], key rows k0..
  const bf16* pw;             // [128][LDB], the table window
  const float *lse, *dl;      // [64] of the query rows
};

// The raw scores ac + bd (f32, unscaled, unmasked) of the warp's 16 query
// rows r16.. against the 64 keys of a tile pair, in the accumulator layout:
// X = Qv . Pw[wb + n]^T, n < 80 (wb = 48 - r16), into the warp's scratch
// xs; ac = Qu . K^T; then the bd term of row rl, key c by one offset read,
// X[rl][15 - rl + c].  xs is free on return.  Used by the forward
// (fwd_kernel_mma) and by the backward's dq launch (pair_prob_g).
__device__ __forceinline__ void score_tile(const bf16* qu, const bf16* qv,
                                           const bf16* k, const bf16* pw,
                                           float* xs, int r16,
                                           float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
  {
    const int wb = 48 - r16;
    float x[10][4];
#pragma unroll
    for (int j = 0; j < 10; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_rows(qv, LDB, r16, kk, lane));
#pragma unroll
      for (int j = 0; j < 10; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, b_rows(pw, LDB, wb + j * 8, kk, lane));
        mma_bf16(x[j], a, b[0], b[1]);
        mma_bf16(x[j + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      *reinterpret_cast<float2*>(xs + gr * LDX + j * 8 + 2 * t4) =
          make_float2(x[j][0], x[j][1]);
      *reinterpret_cast<float2*>(xs + (gr + 8) * LDX + j * 8 + 2 * t4) =
          make_float2(x[j][2], x[j][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(qu, LDB, r16, kk, lane));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_rows(k, LDB, j * 8, kk, lane));
      mma_bf16(s[j], a, b[0], b[1]);
      mma_bf16(s[j + 1], a, b[2], b[3]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = gr + 8 * (e >> 1), c = j * 8 + 2 * t4 + (e & 1);
      s[j][e] += xs[rl * LDX + 15 - rl + c];
    }
  __syncwarp();
}

// prob and g of the warp's 16 query rows against the 64 keys, in the
// accumulator layout (masked entries 0): s = (ac + bd) / sqrt(dk), prob =
// exp(s - lse), g = prob (dO . v - delta) / sqrt(dk), all f32, the Pallas
// kernel's arithmetic.  xs is the warp's scratch; it is free on return.
__device__ __forceinline__ void pair_prob_g(const PairTiles& t, float* xs,
                                            int q0, int k0, int len, int T,
                                            float (&prob)[8][4],
                                            float (&g)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t4 = lane & 3, r16 = warp * 16;
  score_tile(t.qu, t.qv, t.k, t.pw, xs, r16, prob);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[j][e] = 0.f;
  const float lse0 = t.lse[r16 + gr], lse1 = t.lse[r16 + gr + 8];
  const float dl0 = t.dl[r16 + gr], dl1 = t.dl[r16 + gr + 8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = gr + 8 * (e >> 1), c = j * 8 + 2 * t4 + (e & 1);
      const int row = q0 + r16 + rl, col = k0 + c;
      const bool ok = col <= row && col < len && row < T;
      prob[j][e] = ok ? expf(prob[j][e] * kScale - (e >> 1 ? lse1 : lse0))
                      : 0.f;
    }
  // dO . V^T, then g
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_rows(t.dO, LDB, r16, kk, lane));
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_rows(t.v, LDB, j * 8, kk, lane));
      mma_bf16(g[j], a, b[0], b[1]);
      mma_bf16(g[j + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      g[j][e] = prob[j][e] * (g[j][e] - (e >> 1 ? dl1 : dl0)) * kScale;
}

// acc (16 rows x 128, accumulator layout) -> rows r0.. of a [*, 128] bf16
// operand with row stride rs; rows at or past `hi` are not written
__device__ __forceinline__ void store_rows(bf16* out, long long rs, int r0,
                                           int hi, const float (&acc)[16][4]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + gr + 8 * half;
    if (row >= hi) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + row * rs + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// quad (the 4 lanes holding one accumulator row) max and sum
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The bf16 forward on the tensor cores: one CTA per (query tile, b*h), the
// longest query tiles first, in FWD_GROUPS groups of NW warps; each warp
// owns 16 query rows, and group g takes the key tiles j <= i with kt = g
// (mod FWD_GROUPS), so that two groups of one CTA hide each other's
// latencies.  Q_u and Q_v are staged once for all groups; each group's K,
// V and table window come through its own cp.async ring of 2 / FWD_GROUPS
// stages (one group: the next tile loads while this one computes).  Per
// key tile: the scores by score_tile (the backward's), the mask where the
// tile crosses the diagonal or the length, and an online softmax in the
// accumulator layout (row max and sum over the quad; exponents in base 2
// on the SFU, the scale and log2(e) folded into one multiply), the o
// fragments rescaled by alpha, e rounded to bf16 and packed into A
// fragments from registers, V by ldmatrix.trans and o += e . V on
// mma.sync.  The groups' (m, l, o) meet in shared memory at the end.  o =
// acc / max(l, 1e-30) in bf16 and lse = m + log(max(l, 1e-30)) in f32, as
// fwd_kernel<T>.
constexpr int FWD_GROUPS = 2;
constexpr int kFwdStages = 2 / FWD_GROUPS;     // ring stages a group
constexpr int kFwdMmaSmem =
    (2 * kTileB + FWD_GROUPS * kFwdStages * 4 * kTileB) * 2 +
    FWD_GROUPS * NW * kXs * 4;
constexpr float kLog2Scale = kScale * kLog2e;  // scores in base 2
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(NTB * FWD_GROUPS, 1) fwd_kernel_mma(Args a) {
  constexpr int NTF = NTB * FWD_GROUPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qu = reinterpret_cast<bf16*>(smem_raw);   // [64][LDB]
  bf16* Qv = Qu + kTileB;                         // [64][LDB]
  bf16* rings = Qv + kTileB;   // per group, per stage {K, V, Pw (2 tiles)}
  float* xs = reinterpret_cast<float*>(rings + FWD_GROUPS * kFwdStages * 4 * kTileB);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / NW, gt = tid % NTB;      // group, thread in it
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, nq = (T_ + BT - 1) / BT;
  const int qt = nq - 1 - blockIdx.x, q0 = qt * BT;   // long rows first
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const bf16* k = (const bf16*)a.k + off;
  const bf16* v = (const bf16*)a.v + off;
  const bf16* p = (const bf16*)a.p + (long long)h * D;
  const int len = a.len[b];
  const int n_k = len > 0 ? min(qt, (len - 1) / BT) + 1 : 0;
  // this group's key tiles kt = grp + FWD_GROUPS * it, it < n_g
  const int n_g = n_k > grp ? (n_k - grp + FWD_GROUPS - 1) / FWD_GROUPS : 0;
  bf16* ring = rings + grp * kFwdStages * 4 * kTileB;

  auto load = [&](int it) {
    const int kt = grp + FWD_GROUPS * it;
    bf16* st = ring + (it % kFwdStages) * 4 * kTileB;
    cp_rows_by(st, k, rs, kt * BT, BT, T_, gt, NTB);
    cp_rows_by(st + kTileB, v, rs, kt * BT, BT, T_, gt, NTB);
    cp_rows_by(st + 2 * kTileB, p, rs, (T_ - 1) - q0 - 63 + kt * BT, 2 * BT,
               T_, gt, NTB);
  };
  auto group_sync = [&]() {
    if (FWD_GROUPS == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(NTB) : "memory");
  };
  cp_rows_by(Qu, (const bf16*)a.qu + off, rs, q0, BT, T_, tid, NTF);
  cp_rows_by(Qv, (const bf16*)a.qv + off, rs, q0, BT, T_, tid, NTF);
  if (n_g > 0) load(0);
  cp_commit();
  if (kFwdStages == 1) {   // Q from every thread's copies, before the loop
    cp_wait<0>();
    __syncthreads();
  }

  const int gr = lane >> 2, t4 = lane & 3, r16 = (warp % NW) * 16;
  float* xw = xs + warp * kXs;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < n_g; ++it) {
    if (kFwdStages == 2) {
      if (it + 1 < n_g) load(it + 1);
      cp_commit();
      cp_wait<1>();
      group_sync();
    } else if (it > 0) {
      cp_wait<0>();
      group_sync();
    }
    const bf16* st = ring + (it % kFwdStages) * 4 * kTileB;
    const bf16* V = st + kTileB;
    float s[8][4];
    score_tile(Qu, Qv, st, st + 2 * kTileB, xw, r16, s);
    // scores in base 2; -inf where masked (only in a tile that crosses the
    // warp's diagonal or the length); the row max over the quad
    const int k0 = (grp + FWD_GROUPS * it) * BT;
    const bool edge = k0 + BT - 1 > q0 + r16 || k0 + BT > len;
    float mx[2] = {kNegInf, kNegInf};
    uint32_t ok = 0xffffffffu;        // bit 4 j + e: entry (j, e) is valid
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = gr + 8 * (e >> 1), col = k0 + j * 8 + 2 * t4 + (e & 1);
        const bool in = !edge || (col <= q0 + r16 + rl && col < len);
        if (!in) ok &= ~(1u << (4 * j + e));
        s[j][e] = in ? s[j][e] * kLog2Scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float mn[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mn[u] = fmaxf(m[u], quad_max(mx[u]));
      alpha[u] = fast_exp2(m[u] - mn[u]);
    }
    // e = 2^(s - m), 0 where masked; l sums it in f32 before the cast
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = (ok >> (4 * j + e)) & 1
                            ? fast_exp2(s[j][e] - mn[e >> 1]) : 0.f;
        s[j][e] = x;
        sum[e >> 1] += x;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] = l[u] * alpha[u] + quad_sum(sum[u]);
      m[u] = mn[u];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    // o += bf16(e) . V
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t ea[4];
      pack_a(ea, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(V, LDB, j * 8, kk * 16, lane));
        mma_bf16(o[j], ea, f[0], f[1]);
        mma_bf16(o[j + 1], ea, f[2], f[3]);
      }
    }
    group_sync();   // the stage is refilled next
    if (kFwdStages == 1 && it + 1 < n_g) {
      load(it + 1);
      cp_commit();
    }
  }
  if (FWD_GROUPS > 1) {
    // the groups' (m, l, o) meet: group g > 0 leaves its own in the rings
    // ([value][thread in the group]), group 0 folds them in group order
    constexpr int NV = 2 + 2 + 64;
    float* mg = reinterpret_cast<float*>(rings);
    __syncthreads();   // every group is done with its ring
    if (grp > 0) {
      float* at = mg + (grp - 1) * NV * NTB + gt;
      at[0] = m[0]; at[NTB] = m[1]; at[2 * NTB] = l[0]; at[3 * NTB] = l[1];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[(4 + 4 * j + e) * NTB] = o[j][e];
    }
    __syncthreads();
    if (grp > 0) return;
    for (int g2 = 1; g2 < FWD_GROUPS; ++g2) {
      const float* at = mg + (g2 - 1) * NV * NTB + gt;
      float a0[2], a1[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float m2 = at[u * NTB], mn = fmaxf(m[u], m2);
        a0[u] = fast_exp2(m[u] - mn);
        a1[u] = fast_exp2(m2 - mn);
        l[u] = l[u] * a0[u] + at[(2 + u) * NTB] * a1[u];
        m[u] = mn;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j][e] = o[j][e] * a0[e >> 1] + at[(4 + 4 * j + e) * NTB] * a1[e >> 1];
    }
  }
  float lc[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    lc[u] = fmaxf(l[u], 1e-30f);
    const float inv = 1.f / lc[u];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][2 * u] *= inv;
      o[j][2 * u + 1] *= inv;
    }
  }
  store_rows((bf16*)a.o_out + off, rs, q0 + r16, T_, o);
  if (t4 == 0)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = q0 + r16 + gr + 8 * u;
      // m in base 2; a row with no valid key keeps the sentinel
      const float mnat = m[u] == kNegInf ? kNegInf : m[u] * kLn2;
      if (row < T_) a.lse_out[(long long)bh * T_ + row] = mnat + logf(lc[u]);
    }
}

constexpr int kDqMmaSmem = (3 * kTileB + 2 * 4 * kTileB) * 2 + NW * kXs * 4 +
                           2 * BT * 4;

__global__ void __launch_bounds__(NTB, 1) dq_kernel_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qu = reinterpret_cast<bf16*>(smem_raw);   // [64][LDB]
  bf16* Qv = Qu + kTileB;                         // [64][LDB]
  bf16* dO = Qv + kTileB;                         // [64][LDB]
  bf16* ring = dO + kTileB;                       // 2 x {K, V, Pw (2 tiles)}
  float* xs_all = reinterpret_cast<float*>(ring + 8 * kTileB);
  float* lse = xs_all + NW * kXs;                 // [64]
  float* dl = lse + BT;                           // [64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, nq = (T_ + BT - 1) / BT;
  const int qt = nq - 1 - blockIdx.x, q0 = qt * BT;   // long rows first
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const bf16* k = (const bf16*)a.k + off;
  const bf16* v = (const bf16*)a.v + off;
  const bf16* p = (const bf16*)a.p + (long long)h * D;
  const int len = a.len[b];
  const int n_k = len > 0 ? min(qt, (len - 1) / BT) + 1 : 0;

  cp_rows(Qu, (const bf16*)a.qu + off, rs, q0, BT, T_);
  cp_rows(Qv, (const bf16*)a.qv + off, rs, q0, BT, T_);
  cp_rows(dO, (const bf16*)a.dO + off, rs, q0, BT, T_);
  if (tid < BT) {
    const bool in = q0 + tid < T_;
    lse[tid] = in ? a.lse[(long long)bh * T_ + q0 + tid] : 0.f;
    dl[tid] = in ? a.delta[(long long)bh * T_ + q0 + tid] : 0.f;
  }
  auto load = [&](int kt) {
    bf16* st = ring + (kt & 1) * 4 * kTileB;
    cp_rows(st, k, rs, kt * BT, BT, T_);
    cp_rows(st + kTileB, v, rs, kt * BT, BT, T_);
    cp_rows(st + 2 * kTileB, p, rs, (T_ - 1) - q0 - 63 + kt * BT, 2 * BT, T_);
  };
  if (n_k > 0) load(0);
  cp_commit();

  const int gr = lane >> 2, t4 = lane & 3, r16 = warp * 16, wb = 48 - r16;
  float* xs = xs_all + warp * kXs;
  bf16* gw = reinterpret_cast<bf16*>(xs);        // [16][LDX] after X is read
  bf16* pg = a.pg + ((long long)bh * n_pairs(nq) + pair_of(qt, 0)) * 2 * kPair;
  float dqu[16][4], dqv[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqu[j][e] = dqv[j][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) load(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* st = ring + (kt & 1) * 4 * kTileB;
    const PairTiles t{Qu, Qv, dO, st, st + kTileB, st + 2 * kTileB, lse, dl};
    float prob[8][4], g[8][4];
    pair_prob_g(t, xs, q0, kt * BT, len, T_, prob, g);

    // prob and g in bf16 for dkv_kernel_mma and dp_kernel_mma
    bf16* pt = pg + (long long)kt * 2 * kPair;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int at = (r16 + gr + 8 * half) * BT + j * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(pt + at) = __floats2bfloat162_rn(
            prob[j][2 * half], prob[j][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(pt + kPair + at) =
            __floats2bfloat162_rn(g[j][2 * half], g[j][2 * half + 1]);
      }
    // dq_u += g . K
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      uint32_t ga[4];
      pack_a(ga, g[2 * kk], g[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(t.k, LDB, j * 8, kk * 16, lane));
        mma_bf16(dqu[j], ga, f[0], f[1]);
        mma_bf16(dqu[j + 1], ga, f[2], f[3]);
      }
    }
    // gw[rl][15 - rl + c] = g[rl][c], zero elsewhere in [0, 80)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = gr + 8 * (e >> 1), c = j * 8 + 2 * t4 + (e & 1);
        gw[rl * LDX + 15 - rl + c] = __float2bfloat16(g[j][e]);
      }
    {
      const int rl = lane & 15;
      const int u0 = lane < 16 ? 0 : 79 - rl, u1 = lane < 16 ? 15 - rl : 80;
      for (int u = u0; u < u1; ++u) gw[rl * LDX + u] = __float2bfloat16(0.f);
    }
    __syncwarp();
    // dq_v += gw . Pw[wb..wb+79]
#pragma unroll
    for (int kk = 0; kk < 80; kk += 16) {
      uint32_t ga[4];
      ldsm_x4(ga, a_rows(gw, LDX, 0, kk, lane));
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(t.pw + wb * LDB, LDB, j * 8, kk, lane));
        mma_bf16(dqv[j], ga, f[0], f[1]);
        mma_bf16(dqv[j + 1], ga, f[2], f[3]);
      }
    }
    __syncthreads();   // the stage is refilled in the next iteration
  }
  store_rows((bf16*)a.dqu + off, rs, q0 + r16, T_, dqu);
  store_rows((bf16*)a.dqv + off, rs, q0 + r16, T_, dqv);
}

constexpr int kDkvStage = 2 * BT * LDT + 2 * kTileB;   // P, G, dO, Qu
constexpr int kDkvMmaSmem = 2 * kDkvStage * 2;

__global__ void __launch_bounds__(NTB, 2) dkv_kernel_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, nq = (T_ + BT - 1) / BT, kt = blockIdx.x;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const bf16* qu = (const bf16*)a.qu + off;
  const bf16* dOg = (const bf16*)a.dO + off;
  const bf16* pg = a.pg + (long long)bh * n_pairs(nq) * 2 * kPair;
  const int len = a.len[b];
  const int qt0 = kt * BT < len ? kt : nq;   // keys past len: no gradient

  auto load = [&](int qt) {
    bf16* st = ring + ((qt - qt0) & 1) * kDkvStage;
    const bf16* pt = pg + (long long)pair_of(qt, kt) * 2 * kPair;
    cp_pair(st, pt);
    cp_pair(st + BT * LDT, pt + kPair);
    cp_rows(st + 2 * BT * LDT, dOg, rs, qt * BT, BT, T_);
    cp_rows(st + 2 * BT * LDT + kTileB, qu, rs, qt * BT, BT, T_);
  };
  if (qt0 < nq) load(qt0);
  cp_commit();

  const int r16 = warp * 16;
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int qt = qt0; qt < nq; ++qt) {
    if (qt + 1 < nq) load(qt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* P = ring + ((qt - qt0) & 1) * kDkvStage;
    const bf16* G = P + BT * LDT;
    const bf16* dO = G + BT * LDT;
    const bf16* Qu = dO + kTileB;
    // dv += prob^T . dO, dk += g^T . q_u over the 64 query rows
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      uint32_t ap[4], ag[4];
      ldsm_x4_trans(ap, a_cols(P, LDT, r16, kk, lane));
      ldsm_x4_trans(ag, a_cols(G, LDT, r16, kk, lane));
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(dO, LDB, j * 8, kk, lane));
        mma_bf16(dv[j], ap, f[0], f[1]);
        mma_bf16(dv[j + 1], ap, f[2], f[3]);
        ldsm_x4_trans(f, b_cols(Qu, LDB, j * 8, kk, lane));
        mma_bf16(dk[j], ag, f[0], f[1]);
        mma_bf16(dk[j + 1], ag, f[2], f[3]);
      }
    }
    __syncthreads();
  }
  store_rows((bf16*)a.dk + off, rs, kt * BT + r16, T_, dk);
  store_rows((bf16*)a.dv + off, rs, kt * BT + r16, T_, dv);
}

constexpr int kDpStage = BT * LDT + kTileB;            // G, Qv
constexpr int kDpMmaSmem = (kTileB + 2 * kDpStage) * 2;

__global__ void __launch_bounds__(NTB, 2) dp_kernel_mma(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* GW = reinterpret_cast<bf16*>(smem_raw);   // [64][LDB]: gW[r][w]
  bf16* ring = GW + kTileB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int T_ = a.T, nq = (T_ + BT - 1) / BT, dd = blockIdx.x;
  const long long rs = (long long)a.H * D;
  const long long off = (long long)b * T_ * rs + (long long)h * D;
  const bf16* qv = (const bf16*)a.qv + off;
  const bf16* pg = a.pg + (long long)bh * n_pairs(nq) * 2 * kPair;
  const int len = a.len[b];
  // pairs (kt + dd, kt) with a valid key tile
  const int n_it = len > 0 ? min(nq - dd, (len - 1) / BT + 1) : 0;

  auto load = [&](int kt) {
    bf16* st = ring + (kt & 1) * kDpStage;
    cp_pair(st, pg + ((long long)pair_of(kt + dd, kt) * 2 + 1) * kPair);
    cp_rows(st + BT * LDT, qv, rs, (kt + dd) * BT, BT, T_);
  };
  if (n_it > 0) load(0);
  cp_commit();
  // gW's nonzeros sit at the same places for every pair: zero it once
  for (int i = tid; i < kTileB / 8; i += NTB)
    reinterpret_cast<uint4*>(GW)[i] = make_uint4(0, 0, 0, 0);

  float acc[2][16][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  for (int kt = 0; kt < n_it; ++kt) {
    if (kt + 1 < n_it) load(kt + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* G = ring + (kt & 1) * kDpStage;
    const bf16* Qv = G + BT * LDT;
    for (int i = tid; i < kPair; i += NTB) {
      const int r = i / BT, c = i % BT;
      GW[r * LDB + 63 - r + c] = G[r * LDT + c];
    }
    __syncthreads();
    // dPw[w] += sum_r gW[r][w] q_v[r]: warp wi owns w = 32 wi .. 32 wi + 31
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      uint32_t a0[4], a1[4];
      ldsm_x4_trans(a0, a_cols(GW, LDB, warp * 32, kk, lane));
      ldsm_x4_trans(a1, a_cols(GW, LDB, warp * 32 + 16, kk, lane));
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        uint32_t f[4];
        ldsm_x4_trans(f, b_cols(Qv, LDB, j * 8, kk, lane));
        mma_bf16(acc[0][j], a0, f[0], f[1]);
        mma_bf16(acc[0][j + 1], a0, f[2], f[3]);
        mma_bf16(acc[1][j], a1, f[0], f[1]);
        mma_bf16(acc[1][j + 1], a1, f[2], f[3]);
      }
    }
    __syncthreads();
  }
  // dp_part[b][dd][w][h][:] (f32), every w written
  const int gr = lane >> 2, t4 = lane & 3, nt = nq;
  float* part = a.dp_part + ((long long)(b * nt + dd) * 2 * BT * a.H + h) * D;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int w = warp * 32 + m * 16 + gr + 8 * half;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(part + (long long)w * a.H * D + j * 8 +
                                   2 * t4) =
            make_float2(acc[m][j][2 * half], acc[m][j][2 * half + 1]);
    }
}

// dp[(T-1) - delta] = sum over b, then over the diagonals dd whose window
// w = 63 + 64 dd - delta lies in [0, 126]; rows T..2T-2 are 0
__global__ void __launch_bounds__(256) dp_sum_kernel(Args a) {
  const long long hd = (long long)a.H * D;
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (2LL * a.T - 1) * hd) return;
  const int r = (int)(idx / hd);
  const long long col = idx % hd;
  const int nt = (a.T + BT - 1) / BT;
  float x = 0.f;
  if (r < a.T) {
    const int delta = a.T - 1 - r;
    const int lo = delta / 64;
    const int hi = min(nt - 1, (delta + 63) / 64);
    for (int b = 0; b < a.B; ++b)
      for (int dd = lo; dd <= hi; ++dd)
        x += a.dp_part[((long long)(b * nt + dd) * 2 * BT + 63 + 64 * dd -
                        delta) * hd + col];
  }
  ((bf16*)a.dp)[idx] = __float2bfloat16(x);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// f32: the SIMT kernel; bf16: the tensor-core kernel
template <typename T>
int run_fwd(const Args& a, cudaStream_t s) {
  const bool mma = sizeof(T) == 2;
  int err = mma ? set_smem(fwd_kernel_mma, kFwdMmaSmem)
                : set_smem(fwd_kernel<float>, kFwdSmem);
  if (err) return err;
  dim3 grid((a.T + BT - 1) / BT, a.B * a.H);
  if (mma)
    fwd_kernel_mma<<<grid, NTB * FWD_GROUPS, kFwdMmaSmem, s>>>(a);
  else
    fwd_kernel<float><<<grid, NT, kFwdSmem, s>>>(a);
  return (int)cudaGetLastError();
}

// f32: the SIMT kernels
int run_bwd_f32(const Args& a, cudaStream_t s) {
  int err = set_smem(dq_kernel<float>, kDqSmem);
  if (!err) err = set_smem(dkv_kernel<float>, kDkvSmem);
  if (!err) err = set_smem(dp_kernel<float>, kDpSmem);
  if (err) return err;
  const int nt = (a.T + BT - 1) / BT;
  const long long rows = (long long)a.B * a.H * a.T;
  delta_kernel<float><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<float><<<dim3(nt, a.B * a.H), NT, kDqSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dkv_kernel<float><<<dim3(nt, a.B * a.H), NT, kDkvSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dp_kernel<float><<<dim3(nt, a.B * a.H), NT, kDpSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const long long n = (2LL * a.T - 1) * a.H * D;
  dp_reduce_kernel<float><<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernels
int run_bwd_bf16(const Args& a, cudaStream_t s) {
  int err = set_smem(dq_kernel_mma, kDqMmaSmem);
  if (!err) err = set_smem(dkv_kernel_mma, kDkvMmaSmem);
  if (!err) err = set_smem(dp_kernel_mma, kDpMmaSmem);
  if (err) return err;
  const int nt = (a.T + BT - 1) / BT;
  const long long rows = (long long)a.B * a.H * a.T;
  delta_kernel<bf16><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel_mma<<<dim3(nt, a.B * a.H), NTB, kDqMmaSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dkv_kernel_mma<<<dim3(nt, a.B * a.H), NTB, kDkvMmaSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dp_kernel_mma<<<dim3(nt, a.B * a.H), NTB, kDpMmaSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const long long n = (2LL * a.T - 1) * a.H * D;
  dp_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward: o (operand dtype) and lse (f32 [B*H, T]).  dtype 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int tsk_relpos_fwd(const void* qu, const void* qv, const void* k,
                              const void* v, const void* p,
                              const void* lengths, void* o, void* lse,
                              int dtype, int B, int T, int H, void* stream) {
  Args a = {};
  a.qu = qu; a.qv = qv; a.k = k; a.v = v; a.p = p;
  a.len = (const int*)lengths;
  a.o_out = o; a.lse_out = (float*)lse;
  a.B = B; a.T = T; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_fwd<float>(a, s);
  if (dtype == 1) return run_fwd<bf16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's scratch in bytes, in tsk_relpos_bwd's order and layouts
// (below): bytes[0] delta, bytes[1] pg, bytes[2] dp_part, each a long long.
extern "C" int tsk_relpos_bwd_scratch(int dtype, int B, int T, int H,
                                      void* bytes) {
  long long* n = (long long*)bytes;
  const int nt = (T + BT - 1) / BT;
  n[0] = 4LL * B * H * T;
  if (dtype == 0) {
    n[1] = 0;
    n[2] = 4LL * B * T * H * D;
  } else if (dtype == 1) {
    n[1] = 2LL * B * H * n_pairs(nt) * 2 * kPair;
    n[2] = 4LL * B * nt * 2 * BT * H * D;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// Backward: dq_u, dq_v, dk, dv (operand dtype, [B, T, H, 128]) and dp
// (operand dtype, [2T-1, H, 128], summed over the batch) from the forward's
// inputs, o, lse and dO.  Scratch: delta (f32 [B*H, T]); dp_part, f32,
// [B, T, H, 128] for float32 and [B, nt, 128, H, 128] for bfloat16 (nt =
// ceil(T / 64) tile diagonals, 128 window rows each); pg (bfloat16 only:
// prob and g, bf16 64 x 64 each, of the nt (nt + 1) / 2 tile pairs of each
// b*h; null for float32).  Returns cudaGetLastError().
extern "C" int tsk_relpos_bwd(const void* qu, const void* qv, const void* k,
                              const void* v, const void* p,
                              const void* lengths, const void* o,
                              const void* lse, const void* dO, void* dqu,
                              void* dqv, void* dk, void* dv, void* dp,
                              void* delta, void* pg, void* dp_part, int dtype,
                              int B, int T, int H, void* stream) {
  Args a = {};
  a.qu = qu; a.qv = qv; a.k = k; a.v = v; a.p = p;
  a.len = (const int*)lengths;
  a.o = o; a.lse = (const float*)lse; a.dO = dO;
  a.dqu = dqu; a.dqv = dqv; a.dk = dk; a.dv = dv; a.dp = dp;
  a.delta = (float*)delta; a.dp_part = (float*)dp_part; a.pg = (bf16*)pg;
  a.B = B; a.T = T; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_bwd_f32(a, s);
  if (dtype == 1) return run_bwd_bf16(a, s);
  return (int)cudaErrorInvalidValue;
}
