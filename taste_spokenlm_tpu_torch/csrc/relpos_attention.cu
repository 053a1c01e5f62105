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
// [0, T] by the wrapper); dp_part f32 [B, T, H, 128] scratch.  One template
// for f32 and bf16 operands; every product is a true f32 FMA on the SIMT
// units (no TF32, no tensor cores in this first version), operands are
// widened to f32 on their way into shared memory.
//
// Bound on the H100: operations (~3 T^2 dk B H forward and ~8 T^2 dk B H
// backward over the causal half) at the stage-1 shape B=8, T=1599, H=8;
// the kernels run them at the SIMT f32 rate, so they sit well above the
// tensor-core bound until a later version moves the products to wgmma.
//
// Launches (one CTA of 256 threads per tile, 1 CTA per SM for the shared
// memory; causal pruning: a query tile visits key tiles k0 <= q0 only):
//   fwd:      (B*H, query tile): online softmax, o in the operand dtype and
//             lse = m + log(max(l, 1e-30)) in f32, acc / max(l, 1e-30) as
//             the TPU kernel (a row with no valid key gives 0);
//   bwd:      five launches and no float atomics, so the gradients repeat
//             bit for bit: delta = rowsum(dO . o) per row; dq_u, dq_v per
//             (B*H, query tile); dk, dv per (B*H, key tile); dp per (B*H,
//             tile of 64 diagonals delta = i - j) into dp_part[b]; then dp =
//             sum over b in order.  Each recomputes prob = exp(s - lse) and
//             g = prob (dO . v - delta) / sqrt(dk) and rounds prob and g to
//             the operand dtype before its products (the TPU kernel's cast
//             points, relpos_attention.py:197-221).
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

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int run_fwd(const Args& a, cudaStream_t s) {
  int err = set_smem(fwd_kernel<T>, kFwdSmem);
  if (err) return err;
  dim3 grid((a.T + BT - 1) / BT, a.B * a.H);
  fwd_kernel<T><<<grid, NT, kFwdSmem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int run_bwd(const Args& a, cudaStream_t s) {
  int err = set_smem(dq_kernel<T>, kDqSmem);
  if (!err) err = set_smem(dkv_kernel<T>, kDkvSmem);
  if (!err) err = set_smem(dp_kernel<T>, kDpSmem);
  if (err) return err;
  const int nt = (a.T + BT - 1) / BT;
  const long long rows = (long long)a.B * a.H * a.T;
  delta_kernel<T><<<(unsigned)((rows * 32 + NT - 1) / NT), NT, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<T><<<dim3(nt, a.B * a.H), NT, kDqSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dkv_kernel<T><<<dim3(nt, a.B * a.H), NT, kDkvSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  dp_kernel<T><<<dim3(nt, a.B * a.H), NT, kDpSmem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const long long n = (2LL * a.T - 1) * a.H * D;
  dp_reduce_kernel<T><<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(a);
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

// Backward: dq_u, dq_v, dk, dv (operand dtype, [B, T, H, 128]) and dp
// (operand dtype, [2T-1, H, 128], summed over the batch) from the forward's
// inputs, o, lse and dO; delta (f32 [B*H, T]) and dp_part (f32
// [B, T, H, 128]) are scratch.  Returns cudaGetLastError().
extern "C" int tsk_relpos_bwd(const void* qu, const void* qv, const void* k,
                              const void* v, const void* p,
                              const void* lengths, const void* o,
                              const void* lse, const void* dO, void* dqu,
                              void* dqv, void* dk, void* dv, void* dp,
                              void* delta, void* dp_part, int dtype, int B,
                              int T, int H, void* stream) {
  Args a = {};
  a.qu = qu; a.qv = qv; a.k = k; a.v = v; a.p = p;
  a.len = (const int*)lengths;
  a.o = o; a.lse = (const float*)lse; a.dO = dO;
  a.dqu = dqu; a.dqv = dqv; a.dk = dk; a.dv = dv; a.dp = dp;
  a.delta = (float*)delta; a.dp_part = (float*)dp_part;
  a.B = B; a.T = T; a.H = H;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return run_bwd<float>(a, s);
  if (dtype == 1) return run_bwd<bf16>(a, s);
  return (int)cudaErrorInvalidValue;
}
