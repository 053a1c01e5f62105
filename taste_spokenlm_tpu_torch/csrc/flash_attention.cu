// Flash attention for Hopper: softmax(q k^T * scale) v on [B, T, H, D].
//
// Replaces ops/pallas/flash_attention.py `flash_attention` (kernels
// `_block_attn_kernel` and `_flash_kernel`).  The body is attn_kernel in
// attention_core.cuh with the online-softmax schedule: one CTA per
// (batch*head, 64-row query tile), K/V tiles streamed through shared
// memory, f32 accumulation.  f32 inputs use true f32 FMAs; bf16 inputs are
// widened to f32 on load and P is rounded to bf16 before P.V, as in the
// Pallas kernel.  Keys at or past Tk, or past a per-batch true key length
// when `lengths` is given, are masked; `causal` masks col > row.
#include "attention_core.cuh"

using namespace tsk;

template <typename T, int D>
static int run(const void* q, const void* k, const void* v, void* o, int B,
               int Tq, int Tk, int H, float scale, int causal,
               const int* lengths, cudaStream_t stream) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.H = H; a.Tq = Tq; a.Tk = Tk;
  a.q_sb = (long long)Tq * H * D; a.q_st = (long long)H * D; a.q_sh = D;
  a.k_sb = (long long)Tk * H * D; a.k_st = (long long)H * D; a.k_sh = D;
  a.v_sb = a.k_sb; a.v_st = a.k_st; a.v_sh = D;
  a.o_sb = a.q_sb; a.o_st = a.q_st; a.o_sh = D;
  a.scale = scale;
  a.causal = causal;
  a.lengths = lengths;
  return launch_attention<T, D, false>(a, B, stream);
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    int B, int Tq, int Tk, int H, int D, float scale,
                    int causal, const int* len, cudaStream_t s) {
  switch (D) {
    case 32: return run<T, 32>(q, k, v, o, B, Tq, Tk, H, scale, causal, len, s);
    case 64: return run<T, 64>(q, k, v, o, B, Tq, Tk, H, scale, causal, len, s);
    case 128:
      return run<T, 128>(q, k, v, o, B, Tq, Tk, H, scale, causal, len, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q [B, Tq, H, D], k/v [B, Tk, H, D], o [B, Tq, H, D], all contiguous.
// dtype 0 = float32, 1 = bfloat16.  lengths: int32 [B] true key lengths on
// the device, or null for Tk.  Returns cudaGetLastError().
extern "C" int tsk_flash_attention(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Tq, int Tk, int H, int D, float scale,
                                   int causal, const void* lengths,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* len = (const int*)lengths;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Tq, Tk, H, D, scale, causal, len, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k, v, o, B, Tq, Tk, H, D, scale, causal, len, s);
  return (int)cudaErrorInvalidValue;
}
