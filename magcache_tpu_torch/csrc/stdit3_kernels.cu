// K7, K6 and K8 on the Hopper bodies: the C entry points.
//
// K7 replaces magcache_tpu/ops/fused_prologue.py:lnmod_matmul (Pallas body
// _lnmod_mm_kernel):
//     out = [gelu](bf16(bf16(LN(x)) * (1 + scale) + shift) @ w + bias)
// K6 replaces magcache_tpu/ops/attention.py:fused_cross_attention (Pallas
// body _cross_fused_kernel):
//     out = [x +] (softmax(q k^T * scale) v) @ wo^T + bo,  q = x @ wq^T + bq
// over a short context (STDiT3's 300 caption tokens, Latte's 120).
// K8 replaces magcache_tpu/ops/fused_prologue.py:matmul_gated_residual
// (Pallas body _mm_gate_res_kernel), the DiT block's gated epilogue:
//     out = [resid +] gate * (x @ w + bias)
//
// Rounding points, as the TPU kernels have them:
//   K7: two-pass f32 LayerNorm (mean, then the variance of the centred
//       values), y = (x - mean) * rsqrt(var + eps) rounded to bf16, then
//       y * (1 + a) + b in f32 rounded to bf16 as the GEMM operand; f32
//       accumulate, + bias, tanh-gelu in f32, one rounding at the store.
//   K6: q = x @ wq^T in f32, + bq, rounded to bf16; scores in f32, times
//       scale * log2(e); keys at or past kv_valid masked; row-max softmax
//       p = exp2(s - max), l = sum of the f32 p, p rounded to bf16 before
//       PV, divided by l after; o rounded to bf16 before the
//       out-projection; f32 accumulate, + bo, + x in f32 when residual; one
//       rounding at the store.
//   K8: f32 accumulate + bias, rounded to bf16, * gate in f32; with a
//       residual rounded to bf16 again, then + resid in f32; one rounding
//       at the store. Pad rows (rows_out > S) are zeros, not gate * bias.
// Row geometry of K7: x is [B, S, K]; the output is [B, rows_out, N]. Output
// row (b, s) reads x row (b, s) when s < S and is written as zeros
// otherwise (the zero-filled attention-group pad). Modulation rows are
// b / batch_repeat. K8's rows: hopper_gemm.cuh (gate rows) and
// ops/gemm.py::gate_geometry. Weights come as nn.Linear weights, [N, K]
// with K contiguous.
//
// What bounds them on the H100: at STDiT3-XL/2 720p (2 x 54,000 tokens,
// width 1152) K7 is 0.86 (qkv) and 1.15 TFLOP (mlp1) over about 1.3 GB,
// K6 0.57 TFLOP of projections and 0.15 of attention over 0.5 GB, K8 0.29
// TFLOP (projections) and 1.15 (mlp2) over 0.3-1.2 GB: the tensor cores
// bound all of them.
//
// What the design does about it (the bodies' own notes say how):
//   K7: the row-resident body of prologue.cu (layer_norm_kernel, the
//       operand epilogue; entry mc_ln_modulate) writes the normalised and
//       modulated bf16 operand in one pass over x, then the GEMM body of
//       hopper_gemm.cuh (TMA ring, two wgmma consumer warpgroups, 128 x 192
//       tiles, TMA stores) multiplies it with the bias or bias + gelu
//       epilogue. Why the modulation is not done inside the GEMM:
//       hopper_gemm.cuh.
//   K6: three launches. (a) q = bf16(x @ wq^T + bq) on the GEMM body; (b)
//       the attention on hopper_cross_kernel (hopper_attention.cuh: K and V
//       of one (batch, head) resident, query tiles of 128 rows walked
//       through a Q ring, the exact row max with scores scaled after the
//       product); (c) out = bf16([x +] o @ wo^T + bo) on the GEMM body with
//       the residual epilogue. q and o make one round trip through device
//       memory each; the fused mma.sync kernel this replaces kept them in
//       shared memory but, holding a [64, 1152] tile there, re-read both
//       1152 x 1152 weights from L2 for every 64 rows.
//   K8: the GEMM body with the gate epilogue (kEpiGate, kEpiGateResid: the
//       residual tile brought in by TMA as K6's out-projection has it), on
//       flattened rows wherever rows_out == S.

#include "hopper_gemm.cuh"

using hopper::bf16;

// The GEMM body: out [B, rows_out, N] = epilogue(A [B, S, K] @ w^T) with the
// tensor maps of A, w, out (and resid) in `words` (3 or 4 x 16); epi: 0
// bias, 1 bias + gelu, 2 bias + resid [B, S, N].
extern "C" int mc_hopper_gemm(const void* x, const void* w, const long long* words,
                              void* out, const void* bias, const void* resid, int B, int S,
                              int rows_out, int K, int N, int epi, void* stream) {
  hopper::GemmArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.B = B; a.S = S; a.rows_out = rows_out; a.K = K; a.N = N;
  a.m_tiles = (rows_out + hopper::kGemmBM - 1) / hopper::kGemmBM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace hopper;
  switch (epi) {
    case kEpiBias: return launch_gemm<kEpiBias>(x, w, out, resid, words, a, st);
    case kEpiGelu: return launch_gemm<kEpiGelu>(x, w, out, resid, words, a, st);
    case kEpiResid: return launch_gemm<kEpiResid>(x, w, out, resid, words, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K8: out [B, rows_out, N] = [resid +] gate * (A [B, S, K] @ w^T + bias),
// gate row b / rep + s / span of `gate` (f32 rows of N); the maps of A, w,
// out (and resid [B, rows_out, N]) in `words`. resid may be null.
extern "C" int mc_matmul_gated_residual(const void* x, const void* w, const long long* words,
                                        void* out, const void* bias, const void* gate,
                                        const void* resid, int B, int S, int rows_out, int K,
                                        int N, int rep, int span, void* stream) {
  if (rep < 1 || span < 1) return (int)cudaErrorInvalidValue;
  hopper::GemmArgs a{};
  a.bias = static_cast<const float*>(bias);
  a.gate = static_cast<const float*>(gate);
  a.B = B; a.S = S; a.rows_out = rows_out; a.K = K; a.N = N;
  a.m_tiles = (rows_out + hopper::kGemmBM - 1) / hopper::kGemmBM;
  a.rep = rep; a.span = span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace hopper;
  return resid ? launch_gemm<kEpiGateResid>(x, w, out, resid, words, a, st)
               : launch_gemm<kEpiGate>(x, w, out, nullptr, words, a, st);
}

// K6's attention stage: o [B, N, H*72] from q [B, N, H*72] and k, v
// [B, L, H*72] (six maps in `words`), kv_valid <= 512 keys, each block
// walking `tiles_per_block` query tiles of one (batch, head).
extern "C" int mc_cross_attention_tma(const void* q, const void* k, const void* v,
                                      const long long* words, void* o, int B, int N,
                                      int H, int kv_valid, int tiles_per_block,
                                      float q_scale, void* stream) {
  if (kv_valid < 1 || kv_valid > hopper::kCrossKeyTiles * hopper::kBlockN)
    return (int)cudaErrorInvalidValue;
  hopper::CrossArgs a{};
  a.o = static_cast<bf16*>(o);
  a.H = H; a.N = N; a.kv_valid = kv_valid; a.tiles_per_block = tiles_per_block;
  a.q_scale = q_scale;
  const int n_qt = (N + hopper::kBlockM - 1) / hopper::kBlockM;
  const int blocks = (n_qt + tiles_per_block - 1) / tiles_per_block;
  return hopper::launch_cross(q, k, v, words, a, blocks, B * H,
                              static_cast<cudaStream_t>(stream));
}
